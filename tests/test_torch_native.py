"""The port's binding to the C++ host core, and its config, against the JAX
package: the packer against `ops/bitpack.pack_packets`, the host decode and
the fixture encoder against the scalar oracle.  Bit for bit."""

import dataclasses

import numpy as np
import pytest

from conftest import make_config, music_pcm

from saprobe_alac_tpu.codec import decode_packet as oracle
from saprobe_alac_tpu.config import PacketConfig as JaxPacketConfig
from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
from saprobe_alac_tpu.ops.bitpack import pack_packets as jax_pack_packets
from saprobe_alac_tpu_torch import PacketConfig, native

F = 256


def test_packet_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(PacketConfig)] == [
        f.name for f in dataclasses.fields(JaxPacketConfig)
    ]


@pytest.mark.parametrize("rows_extra,width_extra", [(0, 0), (5, 7)])
def test_pack_packets_matches_jax_packer(rows_extra, width_extra):
    cfg = make_config(depth=16, channels=2, frame_length=F)
    pkts = encode_packets(cfg, EncoderSpec(), music_pcm(5 * F - 11, 2, 16, seed=3))
    pkts += [b"", b"\x01\x02\x03"]
    want, _ = jax_pack_packets(pkts)
    rows, width = len(pkts) + rows_extra, want.shape[1] + width_extra
    got = native.pack_packets(pkts, rows, width)
    assert got.shape == (rows, width) and got.dtype == np.int32
    assert np.array_equal(got[: len(pkts), : want.shape[1]], want)
    assert not got[len(pkts) :].any() and not got[:, want.shape[1] :].any()
    with pytest.raises(ValueError):
        native.pack_packets(pkts, rows, native.GUARD_WORDS)


@pytest.mark.parametrize("C", [1, 2])
def test_decode_batch_matches_oracle(C):
    cfg = make_config(depth=16, channels=C, frame_length=F)
    pkts = encode_packets(cfg, EncoderSpec(), music_pcm(4 * F - 5, C, 16, seed=C))
    pkts.append(b"\xa0" + pkts[0][1:])  # tag 5, a PCE element: rejected
    out, lens, errs = native.decode_batch(cfg, pkts)
    for i, p in enumerate(pkts[:-1]):
        assert errs[i] == 0
        assert out[i, : lens[i]].tobytes() == oracle(cfg, p)[0]
    assert errs[-1] != 0


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize(
    "kw,tonality",
    [({}, 0.98), ({}, 0.0), ({"order": 12}, 0.98), ({"order": 31, "mode": 1}, 0.98),
     ({"escape": True}, 0.9)],
)
def test_encode_packets_round_trip(C, kw, tonality):
    cfg = make_config(depth=16, channels=C, frame_length=F)
    pcm = music_pcm(3 * F - 37, C, 16, seed=C + 7, tonality=tonality)
    pkts = native.encode_packets(cfg, pcm, **kw)
    assert len(pkts) == 3
    assert b"".join(oracle(cfg, p)[0] for p in pkts) == pcm.astype("<i2").tobytes()


@pytest.mark.parametrize(
    "depth,C,bsf,want_bs",
    [(24, 1, 1, 1), (24, 2, 1, 1), (24, 2, 2, 2), (32, 1, 1, 1), (32, 2, 2, 2), (32, 2, 0, 1)],
)
def test_encode_packets_bytes_shifted(depth, C, bsf, want_bs):
    """The oracle decodes the fixture encoder's shifted packets to the
    source PCM, and their headers carry the shift (a 32-bit pair at 0 is
    raised to 1).  32-bit music shifted by one byte is 24-bit content: at
    full scale its residuals would make every packet an escape."""
    cfg = make_config(depth=depth, channels=C, frame_length=F)
    quiet = 8 if depth == 32 and bsf < 2 else 0
    pcm = music_pcm(3 * F - 37, C, depth, seed=depth + C) >> quiet
    pkts = native.encode_packets(cfg, pcm, bytes_shifted=bsf)
    want = pcm.astype("<i4").view(np.uint8).reshape(-1, 4)
    want = (want if depth == 32 else want[:, :3]).tobytes()
    assert b"".join(oracle(cfg, p)[0] for p in pkts) == want
    for p in pkts:
        hdr = int.from_bytes(p[:3], "big")  # tag 3, instance 4, unused 12, partial, bs 2, esc
        assert (hdr >> 1) & 1 == 0 and (hdr >> 2) & 3 == want_bs
