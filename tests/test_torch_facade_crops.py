"""The streaming facade as a training-data loader drives it, on the CPU:
random crops through `new_decoder` -> `seek_exact` -> `read`, each crop a
decoder of its own, on one thread and on four threads sharing the
process-wide programs; and the facade's spans (``alac.decoder.*``), the
program's ``alac.program.wait`` and the facade's counters, recorded from
threads other than the one that started the profiler.

A file of F=64 in windows of 4 packets: a crop of 12 packets and more from
inside a packet spans four windows.  ``"cpu"`` runs the kernels' plain
versions through the same windows and programs as the card."""

import gc
import threading

import pytest
from torch.profiler import ProfilerActivity, profile

from torch_files import alac_file

import saprobe_alac_tpu_torch as port
from saprobe_alac_tpu_torch import decode
from saprobe_alac_tpu_torch.ops import program
from saprobe_alac_tpu_torch.utils import profiling

F, WINDOW, RATE = 64, 4, 44100
#: 40 packets, the last one partial.
N = 40 * F - 21
#: Samples a crop: 12 packets and 5 samples.
CROP = 12 * F + 5
BPF = 4  # bytes a stereo 16-bit frame
#: Samples whose time, s / 44100, multiplied back by the rate falls one
#: ulp short of s: ``int(t * rate)`` gives s - 1.
SHORT = [15, 106, 184]
_FILE = []


def _file():
    if not _FILE:
        _FILE.append(alac_file(depth=16, channels=2, frame=F, n=N, seed=41, rate=RATE))
    return _FILE[0]


def _crop(start, backend="cpu"):
    """(position, bytes) of a crop of `CROP` samples from ``start`` through a
    decoder of its own."""
    dec = port.new_decoder(_file().reader(), backend=backend, batch_size=WINDOW)
    pos = dec.seek_exact(start / RATE)
    return pos, dec.read(CROP * BPF)


def _want(start):
    return _file().source[start * BPF : (start + CROP) * BPF]


@pytest.fixture(autouse=True)
def _clean():
    program.clear()
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _run_threads(workers, timeout=300.0):
    """Run callables on threads of their own; re-raise the first error."""
    errors = []

    def wrap(fn):
        def run():
            try:
                fn()
            except BaseException as exc:  # noqa: BLE001 — reported to pytest
                errors.append(exc)

        return run

    threads = [threading.Thread(target=wrap(fn), daemon=True) for fn in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "worker thread hung"
    if errors:
        raise errors[0]


def test_sample_at_gives_back_the_sample_of_its_time():
    """``t = s / rate`` maps back to s at every rate, where the product
    alone falls short for some s; a time between two samples floors."""
    assert [int(s / RATE * RATE) for s in SHORT] == [s - 1 for s in SHORT]
    for rate in (8000, 22050, 44100, 48000, 96000, 192000):
        for s in range(0, 120_000, 7):
            assert decode.sample_at(s / rate, rate) == s
            assert decode.sample_at((s + 0.5) / rate, rate) == s
    assert decode.sample_at(-0.5, RATE) == -22050


@pytest.mark.parametrize("start, backend", [
    (0, "native"), (2 * F + 37, "cpu"), (SHORT[0], "native"), (SHORT[1], "native"),
    (SHORT[2], "cpu"), (N - CROP, "native")])
def test_a_crop_from_inside_a_packet_across_windows(start, backend):
    """A crop from its exact sample, byte for byte the source: from the
    file's first sample, from inside a packet, from samples whose time
    ``int`` would put one sample early, and to the file's last sample; on
    the plain versions and on the C++ core (the same windows)."""
    pos, got = _crop(start, backend)
    assert round(pos * RATE) == start
    assert got == _want(start) and len(got) == CROP * BPF


def test_four_threads_crop_one_file_as_one_thread_does():
    """Four threads, each a decoder a crop, on one file and the programs of
    its keys: the bytes one thread gets, which are the source's, and no
    program made that one thread did not make."""
    starts = [F * (9 * k) + 13 * k + 1 for k in range(4)]
    alone = {s: _crop(s)[1] for s in starts}
    assert all(got == _want(s) for s, got in alone.items())
    keys = {p.key for p in program.programs("cpu") if p.kind == "decode"}
    made = program.counts("cpu")["programs"]
    got = {}

    def worker(s):
        def run():
            got[s] = _crop(s)[1]

        return run

    _run_threads([worker(s) for s in starts])
    assert got == alone
    assert {p.key for p in program.programs("cpu") if p.kind == "decode"} == keys
    assert program.counts("cpu")["programs"] == made


def _by_thread(recorded):
    out = {}
    for s in recorded:
        out.setdefault(s.thread, []).append(s)
    return out


def test_facade_spans_nest_per_thread_with_their_attributes():
    """Two threads under a profiler that the main thread started: each
    records its own tree.  A seek_exact holds its packet reads, its batch
    calls and its skip read; a read says the bytes it returned and the
    windows it dispatched; a packet read says its packets and bytes and
    holds no batch call; every batch call lies inside a read or a seek;
    the program's dispatch holds the wait for its lock.  ``dropped`` is 1
    on a seek past a dispatched window and on a decoder let go with one,
    0 on a seek with none."""
    f = _file()
    got, idents = {}, {}

    def worker(k):
        def run():
            idents[threading.get_ident()] = k
            dec = port.new_decoder(f.reader(), backend="cpu", batch_size=WINDOW)
            dec.seek_exact((2 * F + 37 + k) / RATE)  # fresh: nothing dropped
            a = dec.read(9 * F * BPF)  # dispatches a window ahead
            dec.seek(30 * F / RATE)  # past it: dropped
            b = dec.read(F * BPF)
            dec.seek(0.0)  # dropped again: the read dispatched one ahead
            dec.seek(0.0)  # none to drop
            c = dec.read(5 * F * BPF)
            got[k] = (a, b, c)
            del dec  # let go with a dispatched window

        return run

    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        _run_threads([worker(0), worker(1)])
    recorded = profiling.spans()
    for k, (a, b, c) in got.items():
        s0 = (2 * F + 37 + k) * BPF
        assert a == f.source[s0 : s0 + 9 * F * BPF]
        assert b == f.source[30 * F * BPF : 31 * F * BPF] and c == f.source[: 5 * F * BPF]
    threads = _by_thread(recorded)
    assert len(threads) == 2 and threading.get_ident() not in threads
    for ident, mine in threads.items():
        skip = 37 + idents[ident]
        by_id = {s.id: s for s in mine}
        for s in mine:
            if s.parent is not None:
                up = by_id[s.parent]
                assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
        top = [s for s in mine if s.parent is None]
        assert [(s.name, s.attrs.get("exact"), s.attrs.get("dropped")) for s in top] == [
            (profiling.OPEN, None, None), (profiling.SEEK, 1, 0), (profiling.READ, None, None),
            (profiling.SEEK, 0, 1), (profiling.READ, None, None), (profiling.SEEK, 0, 1),
            (profiling.SEEK, 0, 0), (profiling.READ, None, None), (profiling.CLOSE, None, 1)]
        assert top[0].attrs == {"packets": len(f.packets)}
        reads = [s for s in mine if s.name == profiling.READ]
        # The skip read (one window and the one ahead) nests in the
        # seek_exact; 9 packets' worth from inside packet 2 take the
        # windows from packet 6 and 10, and dispatch the ones after them.
        assert reads[0].parent == top[1].id
        assert [(s.attrs["bytes"], s.attrs["windows"]) for s in reads] == [
            (skip * BPF, 2), (9 * F * BPF, 2), (F * BPF, 2), (5 * F * BPF, 3)]
        for s in mine:
            if s.name == profiling.PACKETS:
                assert by_id[s.parent].name in (profiling.READ, profiling.SEEK)
                assert s.attrs["packets"] == WINDOW and s.attrs["bytes"] > 0
            if s.name == profiling.SUBMIT:
                up = by_id[s.parent]
                assert up.name in (profiling.READ, profiling.SEEK), up
            if s.name == profiling.WAIT:
                assert by_id[s.parent].name == profiling.DISPATCH
            if s.parent is not None and by_id[s.parent].name == profiling.PACKETS:
                pytest.fail(f"{s.name} inside a packet read")
        packets = [s for s in mine if s.name == profiling.PACKETS]
        assert len(packets) == sum(s.attrs["windows"] for s in reads) == 9
        assert sum(s.name == profiling.WAIT for s in mine) == 9


def test_counters_count_opens_windows_and_dropped_windows():
    """``decoder_opens`` a decoder, ``decoder_windows`` a window dispatched
    (the one-packet path's packets too), ``prefetch_dropped`` a dispatched
    window a seek or the decoder's end let go, with or without a
    profiler."""
    f = _file()
    gc.collect()
    program.reset_counts()

    def counts():
        c = program.counts("cpu")
        return c["decoder_opens"], c["decoder_windows"], c["prefetch_dropped"]

    dec = port.new_decoder(f.reader(), backend="native", batch_size=WINDOW)
    assert counts() == (1, 0, 0)
    dec.read(F * BPF)  # window 0 and window 1 ahead
    assert counts() == (1, 2, 0)
    dec.seek(0.5 * dec.duration())
    assert counts() == (1, 2, 1)
    dec.seek(0.0)  # nothing dispatched since
    assert counts() == (1, 2, 1)
    assert dec.read() == f.source  # ten windows, the last with none ahead
    assert counts() == (1, 12, 1)
    del dec
    assert counts() == (1, 12, 1)
    dec = port.new_decoder(f.reader(), backend="native", batch_size=WINDOW)
    dec.read(BPF)
    del dec  # let go with window 1 dispatched
    assert counts() == (2, 14, 2)
    one = port.new_decoder(f.reader(), backend="native", batch_size=1)
    one.read(3 * F * BPF)
    del one
    assert counts() == (3, 17, 2)


class _CountingReader:
    """A reader that counts its reads."""

    def __init__(self, raw):
        self.raw, self.reads = raw, 0

    def seek(self, *args):
        return self.raw.seek(*args)

    def read(self, *args):
        self.reads += 1
        return self.raw.read(*args)


def test_a_window_of_packets_is_one_read():
    """The facade reads a window's packets in one read of the bytes they
    span; packets with another track's bytes between them (a sample table
    of an interleaved file) read past those bytes."""
    import io

    from saprobe_alac_tpu_torch.mp4 import SampleInfo

    f = _file()
    dec = port.new_decoder(f.reader(), backend="native", batch_size=WINDOW)
    counting = _CountingReader(dec._reader)
    dec._reader = counting
    assert dec.read() == f.source
    assert counting.reads == len(f.packets) // WINDOW  # ten windows of four
    blob, samples = bytearray(), []
    for k, p in enumerate(f.packets):
        blob += bytes([k % 251]) * (k % 7)  # another track's bytes
        samples.append(SampleInfo(len(blob), len(p)))
        blob += p
    dec = port.new_decoder(f.reader(), backend="native", batch_size=WINDOW)
    dec._reader, dec._samples = io.BytesIO(bytes(blob)), samples
    assert dec.read() == f.source
    dec.seek_exact(0.0)
    dec._reader = io.BytesIO(bytes(blob[:-5]))  # the last packet cut short
    with pytest.raises(EOFError, match=f"packet {len(f.packets) - 1}"):
        dec.read()
