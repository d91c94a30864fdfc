"""The corpus service's packet reads (service.py `_read_packets`), with no
decode: each file's packets come out of the container byte for byte as the
JAX package's service reads them, one seek and one read a packet, and the
service reads them in runs of at most `READ_RUN_BYTES` (one ``readinto`` a
run into one buffer), counted as ``service_reads`` and as the demux span's
``reads``.

Both services run with a stand-in `BatchDecoder` that keeps the packets it
is given and returns empty PCM, so only the containers are read.
"""

import io
import re
import struct

import pytest
from torch.profiler import ProfilerActivity, profile

from torch_files import alac_file

import saprobe_alac_tpu.service as jax_service
from saprobe_alac_tpu.encoder.mux import _alac_sample_entry, _box, _full_box
from saprobe_alac_tpu_torch import service
from saprobe_alac_tpu_torch.decode import demux_stream
from saprobe_alac_tpu_torch.ops import program
from saprobe_alac_tpu_torch.utils import profiling

F = 64


class _Keeper:
    """A `BatchDecoder` stand-in: keeps every packet it is given, in order,
    and decodes each to ``b""``."""

    packets: list = []

    def __init__(self, config, backend=None):
        pass

    def decode_async(self, pkts):
        type(self).packets.extend(pkts)
        return None

    def finish_async(self, handle, pkts):
        return [b""] * len(pkts)


class _Recording:
    """A reader that records the calls the service makes on it, and has no
    ``readinto``."""

    def __init__(self, raw):
        self.raw, self.calls = raw, []
        self.name = getattr(raw, "name", "<stream>")

    def seek(self, *args):
        self.calls.append(("seek", args[0]))
        return self.raw.seek(*args)

    def read(self, n=-1):
        self.calls.append(("read", n))
        return self.raw.read(n)

    def close(self):
        self.raw.close()


class _RecordingReadinto(_Recording):
    """The same, with ``readinto``."""

    def readinto(self, b):
        self.calls.append(("readinto", len(b)))
        return self.raw.readinto(b)


def _chunked_m4a(f, chunks, gap=0, backwards=False) -> bytes:
    """``f``'s packets in chunks of the counts ``chunks`` (``stsc`` runs),
    ``gap`` bytes of another track after each chunk, the chunks laid out
    last first where ``backwards``; the media data before the movie box."""
    ftyp = _box(b"ftyp", b"M4A " + struct.pack(">I", 0) + b"M4A mp42isom")
    blobs, k = [], 0
    for n in chunks:
        blobs.append(b"".join(f.packets[k : k + n]))
        k += n
    assert k == len(f.packets)
    payload, offsets = bytearray(), [0] * len(chunks)
    for c in (reversed(range(len(chunks))) if backwards else range(len(chunks))):
        offsets[c] = len(ftyp) + 8 + len(payload)
        payload += blobs[c] + bytes((c * 37 + j) % 251 for j in range(gap))
    runs = [(c + 1, n) for c, n in enumerate(chunks) if c == 0 or chunks[c - 1] != n]
    stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1) + _alac_sample_entry(f.config))
    stsc = _full_box(b"stsc", 0, 0, struct.pack(">I", len(runs))
                     + b"".join(struct.pack(">III", c, n, 1) for c, n in runs))
    stsz = _full_box(b"stsz", 0, 0, struct.pack(">II", 0, len(f.packets))
                     + b"".join(struct.pack(">I", len(p)) for p in f.packets))
    stco = _full_box(b"stco", 0, 0, struct.pack(">I", len(offsets))
                     + b"".join(struct.pack(">I", o) for o in offsets))
    stbl = _box(b"stbl", stsd + stsc + stsz + stco)
    moov = _box(b"moov", _box(b"trak", _box(b"mdia", _box(b"minf", stbl))))
    return ftyp + _box(b"mdat", bytes(payload)) + moov


def _stereo():
    return alac_file(16, 2, F, 20 * F + 9, seed=81)


def _runs(samples, bound) -> int:
    """Runs of the sample table: a packet joins the run before it where it
    starts at or after the run's end and the run, to its end, spans at most
    ``bound`` bytes."""
    runs, lo, hi = 0, None, None
    for s in samples:
        if lo is not None and s.offset >= hi and s.offset + s.size - lo <= bound:
            hi = s.offset + s.size
        else:
            runs, lo, hi = runs + 1, s.offset, s.offset + s.size
    return runs


def _blob_and_bound(case):
    """A case's file and the bound it is read under (None: the module's)."""
    if case == "one_chunk":
        return _stereo().blob, None
    if case == "many_chunks":
        return _chunked_m4a(_stereo(), [4, 4, 4, 3, 3, 1, 2]), None
    if case == "foreign_bytes":
        return _chunked_m4a(_stereo(), [5, 5, 2, 9], gap=333), None
    if case == "chunks_out_of_order":
        return _chunked_m4a(_stereo(), [6, 6, 5, 4], gap=17, backwards=True), None
    if case == "run_crosses_the_bound":
        f = _stereo()
        return _chunked_m4a(f, [7, 7, 7], gap=50), 3 * max(map(len, f.packets)) + 20
    if case == "packet_larger_than_the_bound":
        f = _stereo()
        return f.blob, sorted(map(len, f.packets))[len(f.packets) // 2]
    if case == "no_packets":
        return alac_file(16, 2, F, 0, seed=82).blob, None
    if case == "caf":
        return alac_file(24, 1, F, 9 * F + 3, seed=83, container="caf",
                         bytes_shifted=1).blob, None
    if case == "no_readinto":
        return _chunked_m4a(_stereo(), [10, 11], gap=5), None
    raise AssertionError(case)


def _jax_packets(monkeypatch, blob) -> list[bytes]:
    """The packets the JAX package's service reads, one seek and one read a
    packet."""
    monkeypatch.setattr(jax_service, "BatchDecoder", _Keeper)
    _Keeper.packets = []
    for _ in jax_service.iter_decode_corpus([io.BytesIO(blob)]):
        pass
    return _Keeper.packets


CASES = ["one_chunk", "many_chunks", "foreign_bytes", "chunks_out_of_order",
         "run_crosses_the_bound", "packet_larger_than_the_bound", "no_packets", "caf",
         "no_readinto"]


@pytest.mark.parametrize("source", ["path", "file_object"])
@pytest.mark.parametrize("case", CASES)
def test_packets_equal_the_reference_in_runs_under_the_bound(case, source, tmp_path,
                                                             monkeypatch):
    blob, bound = _blob_and_bound(case)
    want = _jax_packets(monkeypatch, blob)
    if bound is not None:
        monkeypatch.setattr(service, "READ_RUN_BYTES", bound)
    bound = service.READ_RUN_BYTES
    wrap = _Recording if case == "no_readinto" else _RecordingReadinto
    readers = []

    def recorded(raw):
        readers.append(wrap(raw))
        return readers[-1]

    if source == "path":
        path = tmp_path / ("track.caf" if case == "caf" else "track.m4a")
        path.write_bytes(blob)
        src = str(path)
        monkeypatch.setattr(service, "open", lambda p, mode: recorded(open(p, mode)),
                            raising=False)
    else:
        src = recorded(io.BytesIO(blob))
    # The demux reads the raw reader, so only the packet reads are recorded.
    monkeypatch.setattr(service, "demux_stream", lambda r: demux_stream(r.raw))
    monkeypatch.setattr(service, "BatchDecoder", _Keeper)
    _Keeper.packets = []
    program.reset_counts()
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        (got,) = list(service.iter_decode_corpus([src], backend="cpu"))
    (demux,) = [s for s in profiling.spans() if s.name == profiling.DEMUX]
    profiling.clear_spans()

    assert got.pcm == b"" and got.index == 0
    assert all(type(p) is bytes for p in _Keeper.packets)
    assert _Keeper.packets == want
    (reader,) = readers
    _, samples = demux_stream(io.BytesIO(blob))
    runs = _runs(samples, bound)
    reads = [(what, n) for what, n in reader.calls if what != "seek"]
    assert len(reads) == runs == sum(what == "seek" for what, _ in reader.calls)
    sizes = set(map(len, want))
    assert all(n <= bound or (what == "read" and n in sizes) for what, n in reads)
    if case == "no_readinto":
        assert {what for what, _ in reads} == {"read"}
    elif case != "packet_larger_than_the_bound":
        assert {what for what, _ in reads} <= {"readinto"}
    assert program.counts("cpu")["service_reads"] == demux.attrs["reads"] == runs
    assert demux.attrs["packets"] == len(want)
    if case in ("one_chunk", "many_chunks", "foreign_bytes", "caf"):
        assert runs == 1
    if case in ("run_crosses_the_bound", "chunks_out_of_order"):
        assert runs > 1
    if case == "packet_larger_than_the_bound":
        assert any(what == "read" and n > bound for what, n in reads)
    if case == "no_packets":
        assert runs == 0 and want == []


def test_a_truncated_file_raises_naming_it(tmp_path, monkeypatch):
    """A file whose last packet is cut short raises `EOFError` naming it."""
    monkeypatch.setattr(service, "BatchDecoder", _Keeper)
    path = tmp_path / "cut.m4a"
    path.write_bytes(_stereo().blob[:-5])
    with pytest.raises(EOFError, match=re.escape(str(path))):
        list(service.iter_decode_corpus([str(path)], backend="cpu"))
