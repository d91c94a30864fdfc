"""The port's Python encoder (`encoder.encode_packets(..., backend="python")`
and `encode_packet`) against the JAX package's: byte-equal packets over the
encoder matrix of tests/test_torch_codec.py (depths, channel counts,
predictor orders, two-stage mode, shift buffers, escapes, stereo mixes,
partial frames), and the packets decode on the CPU device path to the
source."""

import dataclasses

import numpy as np
import pytest

from conftest import expected_pcm_bytes, make_config, music_pcm
from test_torch_codec import SWEEP

from saprobe_alac_tpu.encoder import ChannelSpec as JaxChannelSpec
from saprobe_alac_tpu.encoder import EncoderSpec as JaxEncoderSpec
from saprobe_alac_tpu.encoder import encode_packets as jax_encode_packets
import saprobe_alac_tpu_torch as port
from saprobe_alac_tpu_torch.encoder import encode_packet


def _spec(jspec: JaxEncoderSpec) -> port.EncoderSpec:
    ch = port.ChannelSpec(**dataclasses.asdict(jspec.channel))
    rest = {k: v for k, v in dataclasses.asdict(jspec).items() if k not in ("channel", "elements")}
    return port.EncoderSpec(channel=ch, **rest)


F = 64


def _groups():
    """The matrix's cases by (depth, channels): one CPU decode a group."""
    groups = {}
    for name, case in SWEEP.items():
        kw = dict(depth=16, channels=2, n=None, spec=JaxEncoderSpec(), seed=0,
                  tonality=0.98) | case
        groups.setdefault((kw["depth"], kw["channels"]), {})[name] = kw
    return groups


GROUPS = _groups()


@pytest.mark.parametrize("depth,channels", GROUPS, ids=[f"{d}b{c}ch" for d, c in GROUPS])
def test_python_backend_matches_jax_and_decodes(depth, channels):
    """Each case a stream of F=64 packets (a full and a partial one, or
    the case's own partial length): the port's packets equal the JAX
    package's, and the group's packets decode on the CPU device path to
    the source."""
    cfg = make_config(depth=depth, channels=channels, frame_length=F)
    pcfg = port.PacketConfig(**dataclasses.asdict(cfg))
    packets, want = [], b""
    for kw in GROUPS[depth, channels].values():
        n = kw["n"] if kw["n"] is not None else F + F // 3
        pcm = music_pcm(n, channels, depth, seed=kw["seed"], tonality=kw["tonality"])
        got = port.encode_packets(pcfg, _spec(kw["spec"]), pcm, backend="python")
        assert got == jax_encode_packets(cfg, kw["spec"], pcm, backend="python")
        packets += got
        want += expected_pcm_bytes(pcm, depth)
    dec = port.BatchDecoder(pcfg, "cpu")
    assert b"".join(dec.decode_packets(packets)) == want
    assert dec.impl.last_fallbacks == 0


def test_per_element_specs_and_pb_candidates():
    """Per-element channel specs and adaptive pbFactor (the device encoder's
    options the C++ core refuses) on a six-channel stream."""
    cfg = make_config(depth=24, channels=6, frame_length=128)
    pcm = music_pcm(128 + 50, 6, 24, seed=5)
    els = [JaxChannelSpec(order=o, pb_candidates=(2, 4, 6)) for o in (4, 8, 12, 31)]
    jspec = JaxEncoderSpec(elements=els, bytes_shifted=1)
    pspec = port.EncoderSpec(
        elements=[port.ChannelSpec(**dataclasses.asdict(e)) for e in els], bytes_shifted=1)
    pcfg = port.PacketConfig(**dataclasses.asdict(cfg))
    got = port.encode_packets(pcfg, pspec, pcm, backend="python")
    assert got == jax_encode_packets(cfg, jspec, pcm, backend="python")
    assert encode_packet(pcfg, pspec, pcm[:128]) == got[0]
    assert b"".join(port.BatchDecoder(pcfg, "cpu").decode_packets(got)) == \
        expected_pcm_bytes(pcm, 24)


def test_backend_words():
    """One set of backend words, mapped in one place: the card's word raises
    without a card, an unknown word raises ValueError."""
    cfg = port.PacketConfig(64, 16, 2, 40, 10, 14, 255, 0, 0, 44100)
    pcm = np.zeros((64, 2), np.int64)
    assert port.encode_packets(cfg, port.EncoderSpec(), pcm, backend="python") == \
        port.encode_packets(cfg, port.EncoderSpec(), pcm, backend="cpu")
    for word in ("device", "jax", "auto"):
        with pytest.raises(ValueError, match="backend"):
            port.encode_packets(cfg, port.EncoderSpec(), pcm, backend=word)
