"""The port's BatchDecoder on the CPU device for C = 3..8 and for the
multi-element layouts, against the scalar oracle and the JAX package.

`decode_packets` must give bytes equal to `saprobe_alac_tpu.codec.
decode_packet` and to `JaxBatchDecoder` at 16, 20, 24 and 32 bits, with
bytesShifted 0, 1 and 2, on packets from three encoders (the JAX package's,
the port's host core and the port's device encoder), with no clean packet
on the host path; the hand-built layouts of
tests/test_torch_walk_multislot.py decode to the oracle's bytes; malformed
packets give the oracle's bytes or raise its class.  Odd frame lengths take
the unfused 3-byte packing.
"""

import numpy as np
import pytest

from conftest import make_config, music_pcm

from saprobe_alac_tpu.codec import decode_packet as oracle
from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
from saprobe_alac_tpu.ops.batch import JaxBatchDecoder
from saprobe_alac_tpu_torch import BatchDecoder, ConfigError, native
from saprobe_alac_tpu_torch import encode_packets as port_encode_packets
from saprobe_alac_tpu_torch.interop import encoder_spec_from_jax

import test_torch_walk_multislot as multislot
from test_torch_batch import _oracle_result, _port_result

#: (depth, channels, bytesShifted, frame length)
CONFIGS = [
    (16, 3, 0, 64), (16, 4, 0, 64), (16, 6, 0, 64), (16, 8, 0, 64), (20, 3, 0, 63),
    (20, 5, 0, 64), (24, 6, 1, 64), (24, 8, 1, 64), (24, 3, 1, 63), (32, 7, 1, 64),
    (32, 4, 2, 64), (32, 3, 0, 63),
]


def _pcm(n, C, depth, seed, tonality=0.98):
    """Music; 32-bit content is 24-bit: at full scale every element would be
    an escape."""
    return music_pcm(n, C, depth, seed=seed, tonality=tonality) >> (8 if depth == 32 else 0)


@pytest.mark.parametrize("depth,C,bsf,Fc", CONFIGS)
def test_multichannel_decode_matches_oracle_and_jax(depth, C, bsf, Fc):
    cfg = make_config(depth=depth, channels=C, frame_length=Fc)
    spec = EncoderSpec(bytes_shifted=bsf)
    pkts = encode_packets(cfg, spec, _pcm(2 * Fc + 17, C, depth, depth + C))
    pkts += encode_packets(cfg, spec, music_pcm(Fc, C, depth, seed=depth + C + 1, tonality=0.0))
    want = [oracle(cfg, p)[0] for p in pkts]
    dec = BatchDecoder(cfg, "cpu")
    got = dec.decode_packets(pkts)
    assert got == want
    assert dec.impl.last_fallbacks == 0
    assert len(got[2]) == 17 * C * {16: 2, 20: 3, 24: 3, 32: 4}[depth]
    assert got == JaxBatchDecoder(cfg).decode_packets(pkts)


@pytest.mark.parametrize("backend", ["native", "device"])
@pytest.mark.parametrize("depth,C,bsf,Fc", [(16, 6, 0, 64), (24, 8, 1, 64), (20, 3, 0, 63),
                                            (32, 5, 2, 64)])
def test_multichannel_decode_of_the_ports_own_encoders(depth, C, bsf, Fc, backend):
    """Packets from the port's host core and from its device encoder (on
    the CPU) decode to the source PCM on the device path."""
    cfg = make_config(depth=depth, channels=C, frame_length=Fc)
    pcm = _pcm(2 * Fc + 9, C, depth, 3 * depth + C)
    spec = encoder_spec_from_jax(EncoderSpec(bytes_shifted=bsf))
    pkts = port_encode_packets(cfg, spec, pcm, backend=backend, device="cpu")
    dec = BatchDecoder(cfg, "cpu")
    got = dec.decode_packets(pkts)
    assert dec.impl.last_fallbacks == 0
    assert got == [oracle(cfg, p)[0] for p in pkts]
    vals = pcm.astype(np.int64) << (4 if depth == 20 else 0)
    raw = vals.astype("<i4").view(np.uint8).reshape(-1, 4)
    nbytes = {16: 2, 20: 3, 24: 3, 32: 4}[depth]
    assert b"".join(got) == raw[:, :nbytes].tobytes()
    assert pkts == native.encode_with_spec(cfg, spec, [pcm[i:i + Fc] for i in range(0, len(pcm), Fc)]) \
        or backend == "device"


@pytest.mark.parametrize("depth,C", [(16, 1), (16, 2), (20, 3), (24, 6), (16, 8)])
def test_layouts_and_malformed_packets_match_the_oracle(depth, C):
    """Every packet of the walk test's batch, one at a time: the oracle's
    bytes, or an error of the oracle's class.  The multi-element layouts
    (SCE+SCE stereo and FIL/DSE elements before the audio among them)
    decode on the device path, with no packet on the host."""
    cfg = make_config(depth=depth, channels=C, frame_length=64)
    names, pkts = multislot.batch_packets(cfg, 50 * depth + C)
    dec = BatchDecoder(cfg, "cpu")
    want = [_oracle_result(cfg, p) for p in pkts]
    assert sum(isinstance(x, str) for x in want) >= 3
    clean = [p for p, w in zip(pkts, want) if not isinstance(w, str)]
    assert dec.decode_packets(clean) == [w for w in want if not isinstance(w, str)]
    for name, p, w in zip(names, pkts, want):
        if isinstance(w, str):  # alone: the first malformed packet of a batch raises
            assert _port_result(dec, [clean[0], p]) == w, name
    layouts = dict(zip(names, pkts))
    fit = [layouts[n] for n in ("skips_sce", "dse_sce", "fil_sce_partial", "sce_sce",
                                "skips_pair", "sce_skips_sce", "all_sce", "skips_between",
                                "early_end", "sce_sce_sce", "skips_sce_pair", "sce_end")
           if n in layouts]
    assert fit and dec.decode_packets(fit) and dec.impl.last_fallbacks == 0


@pytest.mark.parametrize("channels", [0, 9])
def test_channel_counts_outside_1_to_8_raise(channels):
    with pytest.raises(ConfigError):
        BatchDecoder(make_config(depth=16, channels=channels, frame_length=64), "cpu")
