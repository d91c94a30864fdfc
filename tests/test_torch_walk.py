"""The port's walk (plain version) against the JAX package at C = 1 and 2.

`walk_batch` is one packet walk for every channel count.  Held bit for bit
(tolerance 0) against `_walk_batch(impl="xla")` (the JAX slot loop) on every
WalkResult field of every lane, and against the JAX package's own choice
for C <= 2, the fused single-slot Pallas element kernel
(`impl="pallas_interpret", fused=True`, B=128): equal on every lane the
fused layout decodes itself, and equal to the JAX slot loop on the lanes it
hands the host with ERR_SLOTS (SCE+SCE stereo, FIL/DSE elements first),
which the port decodes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_config, music_pcm

from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
from saprobe_alac_tpu.ops import walk as jwalk
from saprobe_alac_tpu.ops import walk_kernel as jwalk_kernel
from saprobe_alac_tpu.ops.bitpack import pack_packets
from saprobe_alac_tpu.ops.epilogue import extract_escape
from saprobe_alac_tpu_torch import interop
from saprobe_alac_tpu_torch.ops import walk as pwalk
from saprobe_alac_tpu_torch.ops import walk_kernel as pwalk_kernel

import test_torch_walk_multislot as multislot

F = 256


def _packets(C, tonality=0.98, n=2 * F + 57, seed=None):
    cfg = make_config(depth=16, channels=C, frame_length=F)
    pcm = music_pcm(n, C, 16, seed=seed if seed is not None else C, tonality=tonality)
    return cfg, encode_packets(cfg, EncoderSpec(), pcm)


def _corrupt(C):
    cfg, pkts = _packets(C, n=4 * F, seed=5)
    pkts = [bytearray(p) for p in pkts]
    rng = np.random.default_rng(7)
    pkts[0] = pkts[0][: max(2, len(pkts[0]) // 4)]  # truncation
    for i in range(0, min(len(pkts[1]), 40), 3):  # header/coef bit flips
        pkts[1][i] ^= 1 << int(rng.integers(0, 8))
    pkts[2] = bytearray(b"\xff" * len(pkts[2]))  # all-ones garbage
    return cfg, [bytes(p) for p in pkts]


def _port_walk(cfg, words, sizes):
    return pwalk.walk_batch(
        torch.from_numpy(words), torch.from_numpy(sizes), F=cfg.frame_length,
        C=cfg.num_channels, depth=cfg.bit_depth, pb=cfg.pb, mb=cfg.mb, kb=cfg.kb,
    )


def _jax_walk(cfg, words, sizes, impl, fused=False):
    return jwalk._walk_batch(
        jnp.asarray(words), jnp.asarray(sizes), cfg.frame_length, cfg.num_channels,
        cfg.bit_depth, cfg.pb, cfg.mb, cfg.kb, impl, fused=fused,
    )


def _assert_same(port, ref, lanes, F):
    """Every field equal on ``lanes``; residual rows equal for t < ns on the
    lanes that decoded without error."""
    for name in port._fields:
        if name == "res":
            continue
        a, b = getattr(port, name).numpy(), getattr(ref, name).numpy()
        assert a.shape == b.shape, name
        bad = np.argwhere((a != b)[lanes])
        assert bad.size == 0, f"{name} differs at {bad[:5].tolist()}"
    ok = lanes & (ref.err.numpy() == 0)
    live = (np.arange(F)[None, :, None] < ref.ns.numpy()[None, None, :]) & ok
    a = port.res.numpy()[:, :F]
    b = ref.res.numpy()[:, :F]
    filled = ref.filled.numpy().T[:, None, :] == 1  # (C, 1, B): pass c = channel c
    live = live & filled[: a.shape[0]]
    bad = np.argwhere((a != b) & live)
    assert bad.size == 0, f"res differs at {bad[:5].tolist()}"


def _vs_xla(cfg, pkts):
    words, sizes = pack_packets(pkts)
    port = _port_walk(cfg, words, sizes)
    ref = _jax_walk(cfg, words, sizes, "xla")
    C = cfg.num_channels
    ref = ref._replace(
        res=extract_escape(
            jnp.asarray(words), ref.res, ref.esc, ref.esc_base, ref.esc_cb, ref.role, F, C
        )
    )
    ref = interop.walk_result_from_jax(ref, F, C)
    _assert_same(port, ref, np.ones(len(pkts), bool), F)
    return port


@pytest.mark.parametrize("C", [1, 2])
def test_walk_matches_xla_partial_final(C):
    cfg, pkts = _packets(C)
    port = _vs_xla(cfg, pkts)
    assert (port.err.numpy() == 0).all()
    assert port.ns.numpy()[-1] == 57  # partial final packet


@pytest.mark.parametrize("C", [1, 2])
def test_walk_matches_xla_noise_escape(C):
    cfg, pkts = _packets(C, tonality=0.02, n=3 * F, seed=3)
    port = _vs_xla(cfg, pkts)
    assert (port.esc.numpy() == 1).any(), "noise must produce escape elements"


@pytest.mark.parametrize("C", [1, 2])
def test_walk_matches_xla_corrupt_packets(C):
    cfg, pkts = _corrupt(C)
    port = _vs_xla(cfg, pkts)
    assert (port.err.numpy()[:3] != 0).any()


def test_walk_matches_fused_pallas_kernel():
    """B=128 runs the JAX package's fused single-slot layout through the
    Pallas element kernel in interpret mode: every field and err equal on
    the lanes it decodes; on the SCE+SCE and FIL/DSE lanes it hands the host
    (ERR_SLOTS), every field equal to the JAX slot loop's."""
    cfg, pkts = _packets(2, n=3 * F - 37, seed=11)
    _, noise = _packets(2, tonality=0.0, n=2 * F, seed=12)
    _, bad = _corrupt(2)
    pcm = music_pcm(F, 2, 16, seed=13)
    layouts = [multislot.build_packet(cfg, pcm, lay) for lay in ("SS", "KDP", "SDS")]
    base = pkts + noise + bad + layouts
    batch = [base[i % len(base)] for i in range(128)]
    words, sizes = pack_packets(batch)
    port = _port_walk(cfg, words, sizes)
    fused = interop.walk_result_from_jax(
        _jax_walk(cfg, words, sizes, "pallas_interpret", fused=True), F, 2)
    loop = interop.walk_result_from_jax(_jax_walk(cfg, words, sizes, "pallas_interpret"), F, 2)
    assert fused.res.shape == port.res.shape
    slots = fused.err.numpy() == pwalk.ERR_SLOTS
    assert slots.sum() >= 3 * (128 // len(base))
    _assert_same(port, fused, ~slots, F)
    _assert_same(port, loop, slots, F)
    assert (port.err.numpy()[slots] == 0).all()


def test_constants_match_jax():
    for name in ("ERR_NONE", "ERR_OVERRUN", "ERR_ELEMENT", "ERR_HEADER", "ERR_SHIFT",
                 "ERR_SAMPLES", "ERR_SLOTS", "ERR_WIDTH"):
        assert getattr(pwalk_kernel, name) == getattr(jwalk, name), name
    for name in dir(jwalk_kernel):
        if name.startswith("M_") or name == "META_ROWS":
            assert getattr(pwalk_kernel, name) == getattr(jwalk_kernel, name), name


@pytest.mark.parametrize("kernel", ["element", "packet", "entropy"])
@pytest.mark.parametrize("kb", [-1, 256])
def test_walk_kernels_reject_kb_outside_the_cookie_byte(kernel, kb):
    """kb is the cookie's byte: every walk wrapper raises outside 0..255, on
    the CPU as on the card, since the walk loop's one cursor step a codeword
    needs 0 <= kb."""
    one = torch.ones(4, dtype=torch.int32)
    words = torch.zeros((4, 8), dtype=torch.int32)
    call = {
        "element": lambda: pwalk_kernel.dense_element(
            words, one, one, one, one, one, kb=kb, F=16, depth=16, pb_cfg=40, mb_cfg=10,
            passes=1,
        ),
        "packet": lambda: pwalk_kernel.dense_packet(
            words, one, torch.zeros(1, dtype=torch.int32), kb=kb, F=16, C=1, depth=16,
            pb_cfg=40, mb_cfg=10,
        ),
        "entropy": lambda: pwalk_kernel.dense_entropy(
            words, one, one, one, one, one, one, one, kb=kb, F=16,
        ),
    }[kernel]
    with pytest.raises(ValueError, match="kb must be 0..255"):
        call()
