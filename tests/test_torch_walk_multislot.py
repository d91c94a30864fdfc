"""The port's packet walk (plain version) against the JAX package's slot loop.

`walk_batch(fused=False)` walks every element of a packet (any C = 1..8):
held bit for bit (tolerance 0) against the non-fused `_walk_batch` with
`impl="xla"` and with `impl="pallas_interpret"` (the Pallas element kernel
inside the slot loop, whose contract the packet kernel carries) on every
WalkResult field: of every lane against the Pallas path; against the xla
path ``err`` on every lane and the other fields on the lanes without an
error, because the JAX package's two paths themselves differ in the
metadata of an element whose escape data overruns the packet (the Pallas
path still commits it).  Residual rows are compared on lanes without an
error (the host path replaces the others), escape rows only at t < ns, as
tests/test_parse_kernel.py does.

Batches: music ending in a partial packet, near-white noise (escape
elements), truncated, bit-flipped and all-ones packets at every
configuration; hand-built layouts where they fit: SCE+SCE stereo, FIL and
DSE elements in every skip form before the audio, a pair where one channel
is left, an early END, more elements than the slot budget, and skips that
run past the packet's end.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_config, music_pcm

from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
from saprobe_alac_tpu.encoder.bitwriter import BitWriter
from saprobe_alac_tpu.encoder.encode import _append, _encode_cpe, _encode_sce
from saprobe_alac_tpu.ops import walk as jwalk
from saprobe_alac_tpu.ops.bitpack import pack_packets
from saprobe_alac_tpu.ops.epilogue import extract_escape
from saprobe_alac_tpu_torch import interop
from saprobe_alac_tpu_torch.ops import walk as pwalk
from saprobe_alac_tpu_torch.ops import walk_kernel as pwalk_kernel

F = 256


def skip_elements(w: BitWriter) -> None:
    """Three skip elements: a FIL with 3 bytes, a FIL with the escape count
    (15, then 2: 16 bytes), a DSE of 2 bytes without alignment."""
    w.write(6, 3)
    w.write(3, 4)
    for b in (0x11, 0x22, 0x33):
        w.write(b, 8)
    w.write(6, 3)
    w.write(15, 4)
    w.write(2, 8)
    for i in range(16):
        w.write(i, 8)
    w.write(4, 3)
    w.write(0, 4)
    w.write(0, 1)
    w.write(2, 8)
    w.write(0xAA, 8)
    w.write(0xBB, 8)


def dse_elements(w: BitWriter) -> None:
    """Two more: a DSE with the align flag, a DSE with count 255 + 1."""
    w.write(4, 3)
    w.write(1, 4)
    w.write(1, 1)
    w.write(1, 8)
    w.byte_align()
    w.write(0xCC, 8)
    w.write(4, 3)
    w.write(2, 4)
    w.write(0, 1)
    w.write(255, 8)
    w.write(1, 8)
    for i in range(256):
        w.write(i & 0xFF, 8)


def build_packet(cfg, pcm, layout, spec=EncoderSpec(), end=True) -> bytes:
    """One packet from ``layout``: "S" an SCE of the next channel of ``pcm``,
    "P" a CPE of the next two, "K" `skip_elements`, "D" `dse_elements`, "f" an
    empty FIL."""
    w = BitWriter()
    n, c = pcm.shape[0], 0
    partial = n != cfg.frame_length
    for item in layout:
        if item == "S":
            _append(w, _encode_sce(cfg, spec, spec.channel, 0, pcm[:, c], partial, n))
            c += 1
        elif item == "P":
            _append(w, _encode_cpe(cfg, spec, spec.channel, pcm[:, c], pcm[:, c + 1], partial, n))
            c += 2
        elif item == "K":
            skip_elements(w)
        elif item == "D":
            dse_elements(w)
        else:
            w.write(6, 3)
            w.write(0, 4)
    if end:
        w.write(7, 3)
    w.byte_align()
    return w.getvalue()


def layout_packets(cfg, seed):
    """Hand-built layouts that fit ``cfg.num_channels``: name -> packet."""
    C, depth, F = cfg.num_channels, cfg.bit_depth, cfg.frame_length
    pcm = music_pcm(F, max(C, 2) + 2, depth, seed=seed)
    out = {}
    if C == 1:
        out["skips_sce"] = build_packet(cfg, pcm, "KS")
        out["dse_sce"] = build_packet(cfg, pcm, "DS")
        out["pair_in_mono"] = build_packet(cfg, pcm, "P")  # cpe_break: done, no error
        out["fil_sce_partial"] = build_packet(cfg, pcm[:F // 2], "fS")
    if C == 2:
        out["sce_sce"] = build_packet(cfg, pcm, "SS")
        out["skips_pair"] = build_packet(cfg, pcm, "KDP")
        out["sce_skips_sce"] = build_packet(cfg, pcm, "SDS")
        out["sce_end"] = build_packet(cfg, pcm, "S")  # channel 1 never filled
        out["sce_pair"] = build_packet(cfg, pcm, "SP")  # cpe_break after one SCE
        out["too_many"] = build_packet(cfg, pcm, "ffffffffP")  # > C + 4 elements
        out["budget_end"] = build_packet(cfg, pcm, "fffffS")  # END is element C + 5
        out["no_end"] = build_packet(cfg, pcm, "fffffS", end=False)
    if C == 3:
        out["sce_sce_sce"] = build_packet(cfg, pcm, "fSSS")
        out["sce_sce_pair"] = build_packet(cfg, pcm, "SSP")  # cpe_break at chan 2
        out["skips_sce_pair"] = build_packet(cfg, pcm, "SKDP")
        out["sce_end"] = build_packet(cfg, pcm, "S")  # channels 1 and 2 never filled
    if C >= 6:
        out["all_sce"] = build_packet(cfg, pcm, "S" * C)
        out["skips_between"] = build_packet(cfg, pcm, "SfPKD" + "P" * ((C - 3) // 2) + "S" * ((C - 3) % 2))
        out["early_end"] = build_packet(cfg, pcm, "SP")
    # Skips that run past the end of the packet.
    first = next(iter(out.values()))
    dse = BitWriter()
    dse.write(4, 3)
    dse.write(0, 4)
    dse.write(0, 1)
    dse.write(200, 8)
    dse.byte_align()
    out["dse_overrun"] = dse.getvalue() + first[:20]
    fil = BitWriter()
    fil.write(6, 3)
    fil.write(14, 4)
    fil.byte_align()
    out["fil_overrun"] = fil.getvalue() + first[:8]
    return out


def batch_packets(cfg, seed, bsf=0):
    """The whole batch of one configuration: encoder output (music with a
    partial final packet, noise), corrupted packets, hand-built layouts."""
    C, depth, F = cfg.num_channels, cfg.bit_depth, cfg.frame_length
    spec = EncoderSpec(bytes_shifted=bsf)
    quiet = 8 if depth == 32 else 0  # 24-bit content: full scale is all escapes
    pk = encode_packets(cfg, spec, music_pcm(2 * F + 57, C, depth, seed=seed) >> quiet)
    pk += encode_packets(cfg, spec, music_pcm(F, C, depth, seed=seed + 1, tonality=0.02))
    rng = np.random.default_rng(seed)
    bad = bytearray(pk[1])
    for i in range(0, min(len(bad), 40), 3):  # header/coef bit flips
        bad[i] ^= 1 << int(rng.integers(0, 8))
    late = bytearray(pk[1])
    for i in range(len(late) // 2, len(late) // 2 + 30, 3):  # flips in a later element
        late[i] ^= 1 << int(rng.integers(0, 8))
    pk += [pk[0][: max(2, len(pk[0]) // 4)], pk[0][: len(pk[0]) - 9], bytes(bad), bytes(late),
           b"\xff" * len(pk[0]), b""]
    names = ["music0", "music1", "partial", "noise", "trunc4", "trunc_tail", "flips",
             "late_flips", "ones", "empty"]
    layouts = layout_packets(cfg, seed + 2)
    return names + list(layouts), pk + list(layouts.values())


def port_walk(cfg, words, sizes, fused=False):
    return pwalk.walk_batch(
        torch.from_numpy(words), torch.from_numpy(sizes), F=cfg.frame_length,
        C=cfg.num_channels, depth=cfg.bit_depth, pb=cfg.pb, mb=cfg.mb, kb=cfg.kb, fused=fused,
    )


def jax_walk(cfg, words, sizes, impl):
    """The JAX package's non-fused walk as the port's WalkResult; the xla
    path's escape rows come from its post-hoc extraction."""
    C = cfg.num_channels
    ref = jwalk._walk_batch(
        jnp.asarray(words), jnp.asarray(sizes), cfg.frame_length, C, cfg.bit_depth,
        cfg.pb, cfg.mb, cfg.kb, impl,
    )
    if impl == "xla":
        ref = ref._replace(
            res=extract_escape(
                jnp.asarray(words), ref.res, ref.esc, ref.esc_base, ref.esc_cb, ref.role,
                cfg.frame_length, C,
            )
        )
    return interop.walk_result_from_jax(ref, cfg.frame_length, C)


def assert_same(port, ref, names, F, error_lanes=True):
    for field in port._fields:
        if field == "res":
            continue
        a, b = getattr(port, field).numpy(), getattr(ref, field).numpy()
        assert a.shape == b.shape, field
        lanes = np.ones_like(ref.err.numpy(), bool)
        if field != "err" and not error_lanes:
            lanes = ref.err.numpy() == 0
        bad = np.argwhere((a != b) & lanes.reshape(-1, *([1] * (a.ndim - 1))))
        assert bad.size == 0, f"{field} differs at {[(names[i[0]], *i[1:]) for i in bad[:5].tolist()]}"
    ok = ref.err.numpy() == 0
    valid = np.arange(F)[None, :, None] < ref.ns.numpy()[None, None, :]
    esc = (ref.esc.numpy().T == 1)[:, None, :]  # (C, 1, B)
    live = (valid | ~esc) & ok[None, None, :]
    a, b = port.res.numpy()[:, :F], ref.res.numpy()[:, :F]
    assert a.shape == b.shape
    bad = np.argwhere((a != b) & live)
    assert bad.size == 0, f"res differs at {[(i[0], i[1], names[i[2]]) for i in bad[:5].tolist()]}"


CONFIGS = [(16, 1, 0), (16, 2, 0), (20, 3, 0), (24, 6, 0), (24, 8, 1), (32, 2, 1), (16, 6, 0)]


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("depth,C,bsf", CONFIGS)
def test_packet_walk_matches_jax_slot_loop(depth, C, bsf, impl):
    cfg = make_config(depth=depth, channels=C, frame_length=F)
    names, pkts = batch_packets(cfg, 100 * depth + C, bsf)
    words, sizes = pack_packets(pkts)
    port = port_walk(cfg, words, sizes)
    ref = jax_walk(cfg, words, sizes, impl)
    assert port.res.shape == (C, pwalk_kernel.f_pad(F), len(pkts))
    assert_same(port, ref, names, F, error_lanes=impl != "xla")
    err = dict(zip(names, port.err.tolist()))
    assert err["music0"] == err["partial"] == err["noise"] == 0
    assert port.ns.tolist()[2] == 57
    assert (port.esc.numpy()[3] == 1).any(), "noise must produce escape elements"
    assert err["trunc4"] != 0 and err["empty"] == pwalk.ERR_OVERRUN
    assert err["ones"] == 0 and not port.filled[names.index("ones")].any()  # END comes first
    assert err["dse_overrun"] == err["fil_overrun"] == pwalk.ERR_OVERRUN
    if bsf:
        assert (port.bs.numpy()[0] == bsf).all()
    filled = dict(zip(names, port.filled.sum(1).tolist()))
    if C == 1:
        assert err["skips_sce"] == err["dse_sce"] == err["pair_in_mono"] == err["fil_sce_partial"] == 0
        assert filled["pair_in_mono"] == 0 and port.ns.tolist()[names.index("fil_sce_partial")] == F // 2
    if C == 2:
        for name in ("sce_sce", "skips_pair", "sce_skips_sce", "sce_end", "sce_pair", "budget_end"):
            assert err[name] == 0, name
        assert err["too_many"] == pwalk.ERR_SLOTS and err["no_end"] != 0
        assert filled["sce_end"] == filled["sce_pair"] == 1
        assert port.role.tolist()[names.index("sce_sce")] == [0, 0]
    if C == 3:
        assert err["sce_sce_sce"] == err["sce_sce_pair"] == err["skips_sce_pair"] == 0
        assert filled["sce_sce_pair"] == 2 and filled["sce_end"] == 1
    if C >= 6:
        assert err["all_sce"] == err["skips_between"] == err["early_end"] == 0
        assert filled["skips_between"] == C and filled["early_end"] == 3


@pytest.mark.parametrize("C", [1, 2])
def test_packet_walk_agrees_with_single_slot_walk(C):
    """On single-element packets the two walks of the port agree on every
    field, the fused layout's rows being the packet walk's planes."""
    cfg = make_config(depth=16, channels=C, frame_length=F)
    pkts = encode_packets(cfg, EncoderSpec(), music_pcm(2 * F + 57, C, 16, seed=C))
    words, sizes = pack_packets(pkts)
    a, b = port_walk(cfg, words, sizes, fused=True), port_walk(cfg, words, sizes, fused=False)
    for field in a._fields:
        assert torch.equal(getattr(a, field), getattr(b, field)), field


def test_fused_default_follows_channel_count():
    """Without ``fused`` the walk picks the single-slot layout for C <= 2
    (ERR_SLOTS for SCE+SCE) and the packet walk above it."""
    cfg = make_config(depth=16, channels=2, frame_length=F)
    pkt = build_packet(cfg, music_pcm(F, 2, 16, seed=3), "SS")
    words, sizes = pack_packets([pkt])
    kw = dict(F=F, C=2, depth=16, pb=cfg.pb, mb=cfg.mb, kb=cfg.kb)
    t = torch.from_numpy
    assert pwalk.walk_batch(t(words), t(sizes), **kw).err.tolist() == [pwalk.ERR_SLOTS]
    assert pwalk.walk_batch(t(words), t(sizes), fused=False, **kw).err.tolist() == [0]
    with pytest.raises(ValueError):
        pwalk.walk_batch(t(words), t(sizes), fused=True, **dict(kw, C=3))
