"""The port's scalar oracle (saprobe_alac_tpu_torch/codec/) against the JAX
package's (saprobe_alac_tpu/codec/), packet by packet: the same bytes and
sample count, or an exception of the same class name.  Inputs: the literal
golden vectors of tests/test_golden.py, the encoder sweeps of
tests/test_roundtrip_scalar.py (depths, channel counts, predictor orders,
two-stage mode, shift buffers, escapes, stereo mixes, partial frames), and
truncated and bit-flipped packets, on which the batch decoder's host path
(`ops.batch._host_decode`: the C++ core, then the oracle for a packet the
core rejects) raises the oracle's class too."""

import dataclasses

import numpy as np
import pytest

import test_golden as golden
from conftest import make_config, music_pcm

from saprobe_alac_tpu.codec import decode_packet as jax_oracle
from saprobe_alac_tpu.encoder import EncoderSpec, encode_packet, encode_packets
from saprobe_alac_tpu.encoder.encode import ChannelSpec
from saprobe_alac_tpu_torch import PacketConfig, errors, native
from saprobe_alac_tpu_torch.codec import decode_packet as port_oracle
from saprobe_alac_tpu_torch.ops.batch import _host_decode


def _port(cfg) -> PacketConfig:
    return PacketConfig(**dataclasses.asdict(cfg))


def _outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as exc:  # noqa: BLE001  (the class is the outcome)
        return type(exc).__name__


def _same(cfg, packet):
    """The port's oracle gives the JAX oracle's outcome; returns it."""
    want = _outcome(jax_oracle, cfg, packet)
    assert _outcome(port_oracle, _port(cfg), packet) == want
    return want


GOLDEN = [
    *(pytest.param(dict(channels=c), p, w, id=v.id) for v in golden.VECTORS
      for c, p, w in [v.values]),
    *(pytest.param(dict(depth=d, channels=1), p, w, id=v.id) for v in golden.DEPTH_VECTORS
      for d, p, w in [v.values]),
    pytest.param(dict(channels=1, pb=48, mb=0), golden.PKT_ZERORUN_K32_EDGE,
                 golden.PCM_ZERORUN_K32_EDGE, id="zerorun-k32-edge"),
    pytest.param(dict(channels=1), golden.PKT_PBFACTOR2, golden.PCM_PBFACTOR2, id="pbfactor2"),
    pytest.param(dict(depth=32, channels=2), golden.PKT_CPE_CHANBITS33,
                 golden.PCM_CPE_CHANBITS33, id="chanbits33"),
    pytest.param(dict(channels=1, frame_length=65537), golden.PKT_ZERORUN_MAX,
                 golden.PCM_ZERORUN_MAX, id="zerorun-max"),
    pytest.param(dict(channels=8), golden.PKT_8CH_LAYOUT, golden.PCM_8CH_LAYOUT, id="8ch"),
    pytest.param(dict(channels=1), golden.PKT_MULTI_ELEMENT, golden.PCM_MULTI_ELEMENT,
                 id="fil-dse-sce"),
]


@pytest.mark.parametrize("cfgkw,packet,want", GOLDEN)
def test_golden_vectors(cfgkw, packet, want):
    got = _same(make_config(**cfgkw), packet)
    assert got[0] == want


@pytest.mark.parametrize("cfgkw,packet", [v.values for v in golden.GOLDEN_ERRORS],
                         ids=[v.id for v in golden.GOLDEN_ERRORS])
def test_golden_error_vectors(cfgkw, packet):
    got = _same(make_config(**cfgkw), packet)
    assert isinstance(got, str) and issubclass(getattr(errors, got), errors.DecodeError)


def _sweep(depth=16, channels=2, frame=256, n=None, spec=EncoderSpec(), seed=0, tonality=0.98):
    cfg = make_config(depth=depth, channels=channels, frame_length=frame)
    pcm = music_pcm(frame if n is None else n, channels, depth, seed=seed, tonality=tonality)
    return cfg, encode_packet(cfg, spec, pcm)


SWEEP = {
    **{f"depth{d}-ch{c}": dict(depth=d, channels=c, seed=d * 8 + c)
       for d, cs in ((16, (1, 2, 3, 8)), (20, (2, 5)), (24, (1, 6)), (32, (2, 7))) for c in cs},
    **{f"order{o}": dict(spec=EncoderSpec(channel=ChannelSpec(order=o)), seed=o)
       for o in (0, 1, 5, 8, 12, 30, 31)},
    **{f"mode1-order{o}": dict(spec=EncoderSpec(channel=ChannelSpec(order=o, mode=1)), seed=42)
       for o in (4, 12)},
    **{f"shift{b}-depth{d}-ch{c}": dict(depth=d, channels=c, spec=EncoderSpec(bytes_shifted=b),
                                        seed=d + b)
       for d, b in ((24, 1), (32, 1), (32, 2)) for c in (1, 2)},
    **{f"escape-depth{d}": dict(depth=d, spec=EncoderSpec(escape=True), seed=d, tonality=0.0)
       for d in (16, 20, 24, 32)},
    **{f"mix{r}-{b}": dict(spec=EncoderSpec(mix_res=r, mix_bits=b), seed=r & 0xFF)
       for r, b in ((0, 1), (2, 2), (-1, 1), (127, 7))},
    **{f"partial{n}": dict(frame=4096, n=n, seed=n) for n in (1, 5, 255)},
    "partial3-order12": dict(frame=4096, n=3, seed=33,
                             spec=EncoderSpec(channel=ChannelSpec(order=12, fit=False))),
}


@pytest.mark.parametrize("name", SWEEP)
def test_encoder_sweep(name):
    cfg, pkt = _sweep(**SWEEP[name])
    got = _same(cfg, pkt)
    assert not isinstance(got, str), got


def _corrupted():
    """(name, config, packet): truncations at seven points and seeded bit
    flips of 16-, 24- (bytesShifted=1) and 32-bit stereo packets and a
    six-channel packet, and packets of random bytes."""
    rng = np.random.default_rng(2026)
    out = []
    for depth, ch, bs in ((16, 2, 0), (24, 2, 1), (32, 2, 2), (16, 6, 0)):
        cfg = make_config(depth=depth, channels=ch, frame_length=128)
        pcm = music_pcm(128, ch, depth, seed=depth + ch)
        (pkt,) = encode_packets(cfg, EncoderSpec(bytes_shifted=bs), pcm)
        for cut in (0, 1, 2, 3, 5, len(pkt) // 2, len(pkt) - 1):
            out.append((f"{depth}b{ch}ch-cut{cut}", cfg, pkt[:cut]))
        for k in range(6):
            bad = bytearray(pkt)
            for i in rng.choice(len(bad), size=1 + k, replace=False):
                bad[i] ^= 1 << int(rng.integers(0, 8))
            out.append((f"{depth}b{ch}ch-flip{k}", cfg, bytes(bad)))
    cfg = make_config(channels=2, frame_length=128)
    for k in range(4):
        out.append((f"random{k}", cfg, rng.integers(0, 256, 8 + 9 * k, dtype=np.uint8).tobytes()))
    return out


CORRUPTED = _corrupted()


@pytest.mark.parametrize("case", range(len(CORRUPTED)), ids=[c[0] for c in CORRUPTED])
def test_corrupted_packets(case):
    """The port's oracle and the batch decoder's host path both give the JAX
    oracle's outcome; where the C++ core rejects the packet, the class its
    error code names (`errors.core_error`) is the oracle's class too."""
    _, cfg, pkt = CORRUPTED[case]
    want = _same(cfg, pkt)
    pcfg = _port(cfg)
    got = _outcome(lambda: _host_decode(pcfg, [pkt])[0])
    assert got == (want if isinstance(want, str) else want[0])
    _, _, errs = native.decode_batch(pcfg, [pkt])
    if errs[0]:
        assert type(errors.core_error(int(errs[0]))).__name__ == want
    else:
        assert not isinstance(want, str)


def test_some_corrupted_packets_raise_and_some_decode():
    """The corrupted set exercises both outcomes and several classes."""
    outcomes = [_outcome(jax_oracle, cfg, pkt) for _, cfg, pkt in CORRUPTED]
    classes = {o for o in outcomes if isinstance(o, str)}
    assert len(classes) >= 2 and any(not isinstance(o, str) for o in outcomes)
