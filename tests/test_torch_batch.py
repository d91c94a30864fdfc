"""The port's BatchDecoder on the CPU device against the oracle and JAX.

`decode_packets` must give bytes equal to the scalar oracle and to the JAX
package's `JaxBatchDecoder`; corrupted packets give the oracle's bytes or
its typed error; the host routes, the unsupported configurations and the
CUDA device check behave as specified; and the port decodes a batch with
JAX and the JAX package blocked from import.
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
from saprobe_alac_tpu_torch import BatchDecoder

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


def test_decode_async_round_trip():
    cfg, pkts = _pkts(2, seed=4)
    dec = BatchDecoder(cfg, "cpu")
    handle = dec.decode_async(pkts)
    assert dec.finish_async(handle, pkts) == [oracle(cfg, p)[0] for p in pkts]
    assert dec.decode_packets([]) == []


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
        try:
            want = oracle(cfg, p)[0]
        except Exception as exc:  # the oracle's typed error must surface
            with pytest.raises(type(exc)):
                dec.decode_packets([p])
        else:
            assert dec.decode_packets([p]) == [want]
    truncated = pkts[0][: len(pkts[0]) // 3]
    with pytest.raises(Exception) as raised:
        oracle(cfg, truncated)
    with pytest.raises(type(raised.value)):
        dec.decode_packets([pkts[3], truncated])


def test_kb0_goes_to_host():
    cfg = make_config(depth=16, channels=2, frame_length=F, kb=0)
    pkts = encode_packets(cfg, EncoderSpec(), music_pcm(2 * F, 2, 16, seed=6))
    dec = BatchDecoder(cfg, "cpu")
    assert dec.impl._scalar_only
    got = dec.decode_packets(pkts)
    assert got == [oracle(cfg, p)[0] for p in pkts]


@pytest.mark.parametrize("depth,channels", [(24, 2), (16, 6)])
def test_unported_configs_raise(depth, channels):
    with pytest.raises(NotImplementedError):
        BatchDecoder(make_config(depth=depth, channels=channels, frame_length=F), "cpu")


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        BatchDecoder(make_config(depth=16, channels=2, frame_length=F), "cuda")


def test_port_decodes_with_jax_blocked():
    """With JAX and the JAX package both blocked, the port encodes fixtures
    with its host core and decodes a clean batch to the source PCM."""
    script = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["saprobe_alac_tpu"] = None
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import saprobe_alac_tpu_torch as port
        from saprobe_alac_tpu_torch import native
        cfg = port.PacketConfig(frame_length=64, bit_depth=16, num_channels=2, pb=40,
                                mb=10, kb=14, max_run=255, max_frame_bytes=0,
                                avg_bit_rate=0, sample_rate=44100)
        t = np.arange(200)
        pcm = np.stack([(8000 * np.sin(t / 7)).astype(np.int64),
                        (6000 * np.sin(t / 5)).astype(np.int64)], 1)
        pkts = native.encode_packets(cfg, pcm)
        dec = port.BatchDecoder(cfg, "cpu")
        got = dec.decode_packets(pkts)
        assert b"".join(got) == pcm.astype("<i2").tobytes()
        assert dec.impl.last_fallbacks == 0
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
