"""The port's streaming `Decoder` facade, `PacketDecoder` and
`BatchDecoder.format` against the JAX package's (`backend="native"`) and
the source PCM, byte for byte, on the CPU: whole reads, reads of 777 bytes,
packet-aligned seeks with clamping, `seek_exact`, duration and position,
one-packet windows and a seek that drops the dispatched window.  Files end
in a partial packet and end in a partial window of another bucket shape.
The ``"cpu"`` backend runs the kernels' plain versions through the same
windows as the card; ``"native"`` is the C++ core."""

import io
import os
import random
import subprocess
import sys
import textwrap
import threading

import pytest
import torch

from torch_files import alac_file

from saprobe_alac_tpu import PacketDecoder as JaxPacketDecoder
from saprobe_alac_tpu import decode_file as jax_decode_file
from saprobe_alac_tpu import new_decoder as jax_new_decoder
import saprobe_alac_tpu_torch as port
from saprobe_alac_tpu_torch import cli as port_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (depth, channels, frame, samples, bytesShifted, window): 14 packets in
#: windows of 12 and 2 (buckets 12 and 8), the last packet partial.
CASES = {
    "s16": (16, 2, 128, 13 * 128 + 57, 0, 12),
    "s24_shift1": (24, 2, 128, 13 * 128 + 90, 1, 12),
    "c6": (16, 6, 128, 5 * 128 + 33, 0, 4),
}
_FILES = {}


def _case(name):
    if name not in _FILES:
        depth, ch, frame, n, bs, window = CASES[name]
        f = alac_file(depth=depth, channels=ch, frame=frame, n=n, seed=len(_FILES) + 11,
                      bytes_shifted=bs, rate=48000)
        _FILES[name] = (f, window)
    return _FILES[name]


def _pair(name, backend, window=None):
    """(port decoder, JAX native decoder, source bytes, bytes a frame), both
    decoding windows of the same size."""
    f, default = _case(name)
    window = window or default
    mine = port.new_decoder(f.reader(), backend=backend, batch_size=window)
    ref = jax_new_decoder(f.reader(), backend="native", batch_size=window)
    bpf = f.config.num_channels * port.bytes_per_sample(f.config.bit_depth)
    return mine, ref, f.source, bpf


@pytest.mark.parametrize("backend", ["cpu", "native"])
@pytest.mark.parametrize("name", CASES)
def test_read_all(name, backend):
    mine, ref, src, _ = _pair(name, backend)
    assert mine.format() == port.PCMFormat(**vars(ref.format()))
    got = mine.read()
    assert got == ref.read() == src
    assert mine.read() == b"" and mine.read(10) == b""
    assert mine.position() == ref.position() == mine.duration()


@pytest.mark.parametrize("backend", ["cpu", "native"])
@pytest.mark.parametrize("name", CASES)
def test_read_777_bytes(name, backend):
    mine, _, src, _ = _pair(name, backend)
    chunks = []
    while chunk := mine.read(777):
        assert len(chunk) == 777 or len(b"".join(chunks)) + len(chunk) == len(src)
        chunks.append(chunk)
    assert b"".join(chunks) == src


@pytest.mark.parametrize("fraction", [0.3, 0.8])
@pytest.mark.parametrize("name", CASES)
def test_seek_matches_jax(name, fraction):
    mine, ref, src, bpf = _pair(name, "cpu")
    t = mine.duration() * fraction
    pos = mine.seek(t)
    assert pos == ref.seek(t)
    frame = round(pos * mine.config.sample_rate)
    assert frame % mine.config.frame_length == 0
    assert mine.position() == ref.position() == pos
    got = mine.read()
    assert got == ref.read() == src[frame * bpf :]


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_seek_clamps(backend):
    mine, ref, src, _ = _pair("s16", backend)
    assert mine.seek(-5.0) == ref.seek(-5.0) == 0.0
    assert mine.read(1000) == src[:1000]
    end = mine.seek(1e9)
    assert end == ref.seek(1e9) == mine.duration()
    assert mine.read() == b""
    assert mine.seek(0.0) == 0.0
    assert mine.read() == src


@pytest.mark.parametrize("name", CASES)
def test_seek_exact_matches_jax(name):
    mine, ref, src, bpf = _pair(name, "cpu")
    t = (2 * mine.config.frame_length + 37.5) / mine.config.sample_rate  # mid-packet
    pos = mine.seek_exact(t)
    assert pos == ref.seek_exact(t)
    sample = round(pos * mine.config.sample_rate)
    assert sample == 2 * mine.config.frame_length + 37
    assert mine.read() == ref.read() == src[sample * bpf :]
    assert mine.seek_exact(99.0) == ref.seek_exact(99.0) == mine.duration()
    assert mine.read() == b""


@pytest.mark.parametrize("window", [1, 12])
@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_duration_and_position(backend, window):
    """The position counts the packets decoded so far: after one packet's
    bytes, the first window's."""
    mine, ref, _, bpf = _pair("s16", backend, window)
    f, _ = _case("s16")
    assert mine.duration() == ref.duration() == len(f.packets) * 128 / 48000
    assert mine.position() == 0.0
    mine.read(128 * bpf)  # exactly one packet
    ref.read(128 * bpf)
    assert mine.position() == ref.position() == window * 128 / 48000


def test_seek_drops_the_dispatched_window():
    """A read dispatches the next window; a seek back must not serve it."""
    mine, _, src, bpf = _pair("s16", "cpu")
    assert mine.read(5 * bpf) == src[: 5 * bpf]
    assert mine._prefetch is not None
    mine.seek(0.0)
    assert mine._prefetch is None
    assert mine.read() == src


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_one_packet_windows(backend):
    """batch_size 1: one-packet batches through BatchDecoder on the device
    backends, PacketDecoder on the host."""
    f = alac_file(depth=24, channels=2, frame=128, n=3 * 128 + 5, seed=31, bytes_shifted=1)
    dec = port.new_decoder(f.reader(), backend=backend, batch_size=1)
    assert (dec._batch_dec is None) == (backend == "native")
    pos = dec.seek(128 / 44100)
    assert dec.read() == f.source[round(pos * 44100) * 6 :]


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_caf_decoder(backend):
    f = alac_file(depth=24, channels=1, frame=128, n=4 * 128 + 3, seed=32, container="caf")
    got = port.new_decoder(f.reader(), backend=backend, batch_size=3).read()
    assert got == jax_new_decoder(f.reader(), backend="native").read() == f.source


def test_decode_file_matches_jax(tmp_path):
    f = alac_file(depth=20, channels=2, frame=128, n=2 * 128 + 9, seed=33)
    path = tmp_path / "clip.m4a"
    path.write_bytes(f.blob)
    fmt, samples = port.decode_file(str(path), backend="cpu")
    jfmt, jsamples = jax_decode_file(str(path), backend="native")
    assert vars(fmt) == vars(jfmt)
    assert (samples == jsamples).all() and (samples == f.pcm).all()
    _, from_reader = port.decode_file(f.reader(), backend="native")
    assert (from_reader == f.pcm).all()


def _run_threads(workers, timeout=120.0):
    """Run callables on threads; re-raise the first worker exception."""
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


def test_facade_threads_with_seeks():
    """A Decoder a thread over the same file (tests/test_stress_concurrent.py's
    prefetch case), reads and seeks interleaved: a dropped window must never
    reach another read.  On the C++ core: the window logic is the same for
    every backend, and the plain versions on several threads at once
    oversubscribe the CPU."""
    f, _ = _case("s16")
    bpf = 4

    def worker(seed):
        def run():
            rng = random.Random(seed)
            dec = port.new_decoder(f.reader(), backend="native", batch_size=4)
            for _ in range(8):
                start = round(dec.seek(rng.random() * dec.duration()) * 48000) * bpf
                want = rng.randrange(1, 5 * 128) * bpf
                got = dec.read(want)
                assert got == f.source[start : start + len(got)]
                assert len(got) == min(want, len(f.source) - start)
            dec.seek(0.0)
            assert dec.read() == f.source

        return run

    _run_threads([worker(3000 + i) for i in range(4)])


def test_truncated_mdat_raises_eof():
    f = alac_file(n=6 * 128, seed=34)
    blob = f.blob[: len(f.blob) - len(f.packets[-1]) // 2]
    for dec in (port.new_decoder(io.BytesIO(blob), backend="cpu", batch_size=4),
                jax_new_decoder(io.BytesIO(blob), backend="native")):
        with pytest.raises(EOFError):
            dec.read()


@pytest.mark.parametrize("name", CASES)
def test_packet_decoder_matches_jax(name):
    f, _ = _case(name)
    mine = port.PacketDecoder(f.port_config, "native")
    ref = JaxPacketDecoder(f.config, backend="native")
    assert vars(mine.format()) == vars(ref.format())
    assert [mine.decode_packet(p) for p in f.packets] == [ref.decode_packet(p) for p in f.packets]
    assert b"".join(mine.decode_packet(p) for p in f.packets) == f.source


@pytest.mark.parametrize("name", CASES)
def test_packet_decoder_cpu_decodes_batches_of_one(name):
    """``"cpu"`` decodes each packet as a one-packet batch through the
    kernels' plain versions, as ``"cuda"`` does on the card: the first two
    packets and the partial last one, each equal to the JAX package's."""
    f, _ = _case(name)
    mine = port.PacketDecoder(f.port_config, "cpu")
    ref = JaxPacketDecoder(f.config, backend="native")
    assert mine.format() == port.PCMFormat(48000, f.config.bit_depth, f.config.num_channels)
    for p in (f.packets[0], f.packets[1], f.packets[-1]):
        assert mine.decode_packet(p) == ref.decode_packet(p)


def test_packet_decoder_rejects_like_jax():
    f, _ = _case("s16")
    bad = f.packets[1][: len(f.packets[1]) // 4]
    with pytest.raises(Exception) as ref:
        JaxPacketDecoder(f.config, backend="native").decode_packet(bad)
    for backend in ("native", "cpu"):
        with pytest.raises(port.DecodeError) as mine:
            port.PacketDecoder(f.port_config, backend).decode_packet(bad)
        assert type(mine.value).__name__ == type(ref.value).__name__


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_batch_decoder_format_and_windows(backend):
    f, _ = _case("c6")
    dec = port.BatchDecoder(f.port_config, backend)
    assert dec.format() == port.PCMFormat(48000, 16, 6)
    handle = dec.decode_async(f.packets[:3])
    assert b"".join(dec.finish_async(handle, f.packets[:3])) == f.source[: 3 * 128 * 12]
    assert dec.decode_packets([]) == [] and dec.finish_async(dec.decode_async([]), []) == []


def test_unsupported_bit_depth():
    cfg = port.PacketConfig(4096, 8, 2, 40, 10, 14, 255, 0, 0, 44100)
    for make in (port.PacketDecoder, lambda c: port.BatchDecoder(c, "native")):
        with pytest.raises(port.UnsupportedBitDepth):
            make(cfg)


def _scalar_decode(entry, f, tmp_path):
    """The source file's PCM decoded by one entry point of the port with
    ``backend="scalar"``."""
    packets = f.packets
    cfg = f.port_config
    if entry == "Decoder":
        return port.new_decoder(f.reader(), backend="scalar", batch_size=5).read()
    if entry == "Decoder-one-packet":
        return port.Decoder(f.reader(), backend="scalar", batch_size=1).read()
    if entry == "decode_file":
        fmt, samples = port.decode_file(f.reader(), backend="scalar")
        return port.utils.array_to_pcm_bytes(fmt, samples)
    if entry == "PacketDecoder":
        dec = port.PacketDecoder(cfg, "scalar")
        return b"".join(dec.decode_packet(p) for p in packets)
    if entry == "BatchDecoder":
        dec = port.BatchDecoder(cfg, "scalar")
        handle = dec.decode_async(packets[3:])
        return b"".join(dec.decode_packets(packets[:3]) + dec.finish_async(handle, packets[3:]))
    if entry == "service":
        (res,) = port.decode_corpus([f.reader()], backend="scalar", batch_size=4)
        return res.pcm
    path, out = tmp_path / "in.m4a", tmp_path / "out.pcm"
    path.write_bytes(f.blob)
    assert port_cli.main(["-format", "pcm", "-backend", "scalar", "-batch", "3", str(path),
                          str(out)]) == 0
    return out.read_bytes()


SCALAR_ENTRIES = ["Decoder", "Decoder-one-packet", "decode_file", "PacketDecoder",
                  "BatchDecoder", "service", "cli"]


@pytest.mark.parametrize("entry", SCALAR_ENTRIES)
def test_scalar_backend_decodes_to_the_jax_oracles_bytes(entry, tmp_path):
    """``backend="scalar"`` decodes through the port's own oracle at every
    entry point: the JAX package's oracle's bytes (its facade on
    ``"scalar"``), which are the source's."""
    f, _ = _case("s24_shift1")
    want = jax_new_decoder(f.reader(), backend="scalar").read()
    assert want == f.source
    assert _scalar_decode(entry, f, tmp_path) == want


def test_scalar_packet_decoder_raises_the_oracles_class():
    """A truncated packet on ``"scalar"``: the class the JAX oracle raises."""
    f, _ = _case("c6")
    bad = f.packets[1][: len(f.packets[1]) // 2]
    with pytest.raises(port.DecodeError) as mine:
        port.PacketDecoder(f.port_config, "scalar").decode_packet(bad)
    with pytest.raises(Exception) as ref:
        JaxPacketDecoder(f.config, "scalar").decode_packet(bad)
    assert type(mine.value).__name__ == type(ref.value).__name__


def test_cuda_decoder_raises_without_a_card():
    """The default backend is the card; without one it raises and does not
    decode on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default backend decodes on it")
    f, _ = _case("s16")
    for call in (lambda: port.new_decoder(f.reader()), lambda: port.decode_file(f.reader()),
                 lambda: port.Decoder(f.reader(), backend="cuda", batch_size=1),
                 lambda: port.PacketDecoder(f.port_config)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_facade_runs_with_jax_blocked(tmp_path):
    """With JAX and the JAX package blocked from import, the port writes an
    M4A, opens it, seeks and reads it to the source on the CPU."""
    script = textwrap.dedent(
        f"""
        import io, sys
        sys.modules["jax"] = None
        sys.modules["saprobe_alac_tpu"] = None
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import saprobe_alac_tpu_torch as port
        from saprobe_alac_tpu_torch.encoder import encode_to_m4a
        from saprobe_alac_tpu_torch.utils.pcmconv import array_to_pcm_bytes
        fmt = port.PCMFormat(44100, 16, 2)
        t = np.arange(700)
        pcm = np.stack([(3000 * np.sin(t / 7)).astype(np.int64),
                        (2000 * np.sin(t / 5)).astype(np.int64)], 1)
        blob = encode_to_m4a(fmt, pcm, frame_length=128, backend="native")
        dec = port.new_decoder(io.BytesIO(blob), backend="cpu", batch_size=4)
        src = array_to_pcm_bytes(fmt, pcm)
        assert dec.read() == src
        dec.seek(256 / 44100)
        assert dec.read() == src[256 * 4 :]
        print("ok")
        """
    )
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
