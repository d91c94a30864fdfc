"""The port's BatchDecoder on the CPU device against the oracle and JAX.

`decode_packets` must give bytes equal to the scalar oracle and to the JAX
package's `JaxBatchDecoder` at every depth (16, 20, 24 and 32 bits, with
bytesShifted 0, 1 and 2); corrupted packets give the oracle's bytes or an
error of the oracle's class (the port's classes carry the same names); the
host routes, the unsupported configurations and the device default behave
as specified; and the port decodes 16- and 24-bit batches, and raises its
typed error, with JAX and the JAX package blocked from import.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import make_config, music_pcm

from saprobe_alac_tpu.codec import decode_packet as oracle
from saprobe_alac_tpu.encoder import ChannelSpec, EncoderSpec, encode_packets
from saprobe_alac_tpu.ops.batch import JaxBatchDecoder
from saprobe_alac_tpu_torch import AlacError, BatchDecoder, ConfigError, TorchBatchDecoder

F = 256
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkts(C, spec=EncoderSpec(), n=3 * F - 37, seed=0, tonality=0.98):
    cfg = make_config(depth=16, channels=C, frame_length=F)
    return cfg, encode_packets(cfg, spec, music_pcm(n, C, 16, seed=seed, tonality=tonality))


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize(
    "name,spec,tonality",
    [
        ("std", EncoderSpec(), 0.98),
        ("noise", EncoderSpec(), 0.0),
        ("o12", EncoderSpec(channel=ChannelSpec(order=12)), 0.98),
        ("o31_mode1", EncoderSpec(channel=ChannelSpec(order=31, mode=1)), 0.98),
    ],
)
def test_decode_matches_oracle_and_jax(C, name, spec, tonality):
    cfg, pkts = _pkts(C, spec, seed=C, tonality=tonality)
    want = [oracle(cfg, p)[0] for p in pkts]
    dec = BatchDecoder(cfg, "cpu")
    got = dec.decode_packets(pkts)
    assert got == want
    assert dec.impl.last_fallbacks == 0
    assert got == JaxBatchDecoder(cfg).decode_packets(pkts)


@pytest.mark.parametrize(
    "depth,C,bsf", [(20, 1, 0), (20, 2, 0), (24, 1, 1), (24, 2, 1), (32, 1, 1), (32, 2, 2)]
)
def test_hires_decode_matches_oracle_and_jax(depth, C, bsf):
    """Music with bytesShifted (the shift region through the raw reader),
    near-white noise (escape elements, no shift) and a partial final
    packet.  32-bit mono music is 24-bit content: at full scale every
    packet would be an escape."""
    cfg = make_config(depth=depth, channels=C, frame_length=F)
    spec = EncoderSpec(bytes_shifted=bsf)
    quiet = 8 if (depth, C) == (32, 1) else 0
    pkts = encode_packets(cfg, spec, music_pcm(2 * F, C, depth, seed=depth + C) >> quiet)
    pkts += encode_packets(
        cfg, spec, music_pcm(2 * F - 37, C, depth, seed=depth + C + 1, tonality=0.0)
    )
    want = [oracle(cfg, p)[0] for p in pkts]
    dec = BatchDecoder(cfg, "cpu")
    w = dec.impl
    got = dec.decode_packets(pkts)
    assert got == want
    assert w.last_fallbacks == 0
    assert len(got[-1]) < len(got[0])
    assert got == JaxBatchDecoder(cfg).decode_packets(pkts)


def test_decode_async_round_trip():
    cfg, pkts = _pkts(2, seed=4)
    dec = BatchDecoder(cfg, "cpu")
    handle = dec.decode_async(pkts)
    assert dec.finish_async(handle, pkts) == [oracle(cfg, p)[0] for p in pkts]
    assert dec.decode_packets([]) == []


def _oracle_result(cfg, packet):
    """The oracle's bytes, or the class name of the error it raises."""
    try:
        return oracle(cfg, packet)[0]
    except Exception as exc:
        return type(exc).__name__


def _port_result(dec, packets):
    try:
        return dec.decode_packets(packets)[-1]
    except Exception as exc:
        assert isinstance(exc, AlacError), f"{type(exc).__name__} is not the port's"
        return type(exc).__name__


def test_corrupt_packets_match_oracle_or_raise_its_error():
    cfg, pkts = _pkts(2, n=4 * F, seed=5)
    pkts = [bytearray(p) for p in pkts]
    rng = np.random.default_rng(7)
    for i in range(1, min(len(pkts[1]), 40), 3):
        pkts[1][i] ^= 1 << int(rng.integers(0, 8))
    pkts[2] = bytearray(b"\xff" * len(pkts[2]))
    pkts = [bytes(p) for p in pkts]
    dec = BatchDecoder(cfg, "cpu")
    for p in pkts:
        assert _port_result(dec, [p]) == _oracle_result(cfg, p)
    truncated = pkts[0][: len(pkts[0]) // 3]
    assert isinstance(_oracle_result(cfg, truncated), str)
    assert _port_result(dec, [pkts[3], truncated]) == _oracle_result(cfg, truncated)


@pytest.mark.parametrize(
    "depth,C,bsf", [(16, 2, 0), (24, 2, 1), (24, 1, 1), (20, 2, 0), (32, 2, 2)]
)
def test_fuzzed_packets_raise_the_oracles_class(depth, C, bsf):
    """Bit flips (in the header and anywhere), truncations and all-0xFF
    packets: the port gives the oracle's bytes or raises its own class of
    the oracle's name (the host core's error code picks the class)."""
    Ff = 64
    cfg = make_config(depth=depth, channels=C, frame_length=Ff)
    pcm = music_pcm(3 * Ff, C, depth, seed=depth + C)
    clean = encode_packets(cfg, EncoderSpec(bytes_shifted=bsf), pcm)
    rng = np.random.default_rng(depth * 10 + C)
    fuzzed = []
    for k in range(32):
        p = bytearray(clean[k % len(clean)])
        if k % 4 == 0:
            p = p[: int(rng.integers(0, len(p)))]
        elif k % 4 == 3:
            p = bytearray(b"\xff" * int(rng.integers(1, len(p) + 1)))
        else:
            hi = 12 if k % 4 == 1 else len(p)
            for _ in range(int(rng.integers(1, 4))):
                p[int(rng.integers(0, hi))] ^= 1 << int(rng.integers(0, 8))
        fuzzed.append(bytes(p))
    dec = BatchDecoder(cfg, "cpu")
    want = [_oracle_result(cfg, p) for p in fuzzed]
    assert sum(isinstance(x, str) for x in want) >= 8
    assert [_port_result(dec, [p]) for p in fuzzed] == want


def test_kb0_goes_to_host():
    cfg = make_config(depth=16, channels=2, frame_length=F, kb=0)
    pkts = encode_packets(cfg, EncoderSpec(), music_pcm(2 * F, 2, 16, seed=6))
    dec = BatchDecoder(cfg, "cpu")
    assert dec.impl._scalar_only
    got = dec.decode_packets(pkts)
    assert got == [oracle(cfg, p)[0] for p in pkts]


@pytest.mark.parametrize("depth,channels", [(24, 6), (16, 6)])
def test_unported_configs_raise(depth, channels):
    """Every channel count of the format (1..8) is ported, so these
    configurations construct; a count beyond it raises."""
    dec = BatchDecoder(make_config(depth=depth, channels=channels, frame_length=F), "cpu")
    assert dec.impl.config.num_channels == channels and not dec.impl._scalar_only
    with pytest.raises(ConfigError):
        BatchDecoder(make_config(depth=depth, channels=channels + 3, frame_length=F), "cpu")


def test_unsupported_depth_raises_config_error():
    with pytest.raises(ConfigError):
        BatchDecoder(make_config(depth=18, channels=2, frame_length=F), "cpu")


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        BatchDecoder(make_config(depth=16, channels=2, frame_length=F), "cuda")


def test_default_device_is_cuda():
    dec = BatchDecoder.__init__.__defaults__, TorchBatchDecoder.__init__.__defaults__
    assert dec == (("cuda",), ("cuda",))
    if torch.cuda.is_available():
        assert BatchDecoder(make_config(frame_length=F)).impl.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            BatchDecoder(make_config(depth=24, channels=2, frame_length=F))


def test_port_decodes_with_jax_blocked():
    """With JAX and the JAX package both blocked, the port encodes fixtures
    with its host core, decodes a clean 16-bit and a clean 24-bit
    bytesShifted=1 batch to the source PCM, and raises its own
    BitstreamOverrun for a truncated packet."""
    script = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["saprobe_alac_tpu"] = None
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import saprobe_alac_tpu_torch as port
        from saprobe_alac_tpu_torch import native
        t = np.arange(200)
        for depth, bs, fmt in ((16, 0, "<i2"), (24, 1, None)):
            cfg = port.PacketConfig(frame_length=64, bit_depth=depth, num_channels=2, pb=40,
                                    mb=10, kb=14, max_run=255, max_frame_bytes=0,
                                    avg_bit_rate=0, sample_rate=44100)
            amp = 1 << (depth - 3)
            pcm = np.stack([(amp * np.sin(t / 7)).astype(np.int64),
                            (amp * np.sin(t / 5)).astype(np.int64)], 1)
            pkts = native.encode_packets(cfg, pcm, bytes_shifted=bs)
            dec = port.BatchDecoder(cfg, "cpu")
            got = b"".join(dec.decode_packets(pkts))
            if fmt is None:  # 3-byte little-endian samples
                want = pcm.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
            else:
                want = pcm.astype(fmt).tobytes()
            assert got == want, depth
            assert dec.impl.last_fallbacks == 0
        try:
            dec.decode_packets([pkts[0], pkts[1][: len(pkts[1]) // 3]])
        except port.BitstreamOverrun:
            pass
        else:
            raise AssertionError("a truncated packet decoded")
        print("OK")
        """
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=120, env=env
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_port_sources_import_nothing_of_jax():
    """No module of the port, and not chip_smoke.py, imports JAX or the JAX
    package, at top level or inside a function."""
    import ast
    from pathlib import Path

    files = sorted(Path(REPO, "saprobe_alac_tpu_torch").rglob("*.py"))
    files.append(Path(REPO, "chip_smoke.py"))
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "saprobe_alac_tpu"), f"{path}: {name}"
