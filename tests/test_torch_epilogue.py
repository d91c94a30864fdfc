"""The port's epilogue against saprobe_alac_tpu/ops/epilogue.py.

Random reconstructed planes and per-lane metadata (mix shifts and weights,
roles, SMPTE channel slots, unfilled slots, bytes shifted and shift values)
go through both; the packed output must be equal bit for bit (tolerance 0),
for C = 1 and C = 2 at every depth, on the fused packings and on the
fallback (F*C not a multiple of 4); and for C = 3..8 with each channel
count's element layout (pairs and singles in bitstream order, the SMPTE
remap, unfilled channels).  `extract_shift` at C = 3, 6 and 8 is held to
`extract_shift_kernel` (the Pallas raw reader in interpret mode) on random
words and shift regions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saprobe_alac_tpu.ops.epilogue import extract_shift_kernel
from saprobe_alac_tpu.ops.epilogue import finish_packed as jax_finish_packed
from saprobe_alac_tpu_torch.encoder.spec import CHANNEL_LAYOUT_OFFSETS, element_layout
from saprobe_alac_tpu_torch.ops.epilogue import extract_shift, finish_packed

F = 64
B = 24


def _inputs(C, seed, F=F):
    rng = np.random.default_rng(seed)
    mix = rng.integers(-(2**17), 2**17, size=(F, C * B), dtype=np.int64).astype(np.int32)
    mix[:, :3] = rng.integers(-(2**31), 2**31 - 1, size=(F, 3))  # wrap corners
    mixbits = rng.integers(0, 32, size=(B, C)).astype(np.int32)
    mixres = rng.integers(-128, 128, size=(B, C)).astype(np.int32)
    mixres[:4] = 0  # no decorrelation on these lanes
    if C == 2:
        pair = rng.random(B) < 0.8
        role = np.stack([np.where(pair, 1, 0), np.where(pair, 2, 0)], 1).astype(np.int32)
        out_chan = np.tile(np.array([0, 1], np.int32), (B, 1))
        out_chan[::5] = [1, 0]  # swapped slots
    else:
        role = np.zeros((B, 1), np.int32)
        out_chan = np.zeros((B, 1), np.int32)
    filled = (rng.random((B, C)) < 0.9).astype(np.int32)
    return mix, mixbits, mixres, role, out_chan, filled


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_finish_packed_matches_jax(C, seed):
    mix, mixbits, mixres, role, out_chan, filled = _inputs(C, seed)
    zeros = np.zeros((B, C), np.int32)
    want = np.asarray(
        jax_finish_packed(
            jnp.asarray(mix), jnp.zeros((F, C, B), jnp.int32), jnp.asarray(zeros),
            jnp.asarray(mixbits), jnp.asarray(mixres), jnp.asarray(role),
            jnp.asarray(out_chan), jnp.asarray(filled), F, C, 16,
        )
    )
    t = torch.from_numpy
    got = finish_packed(
        t(mix), None, t(zeros), t(mixbits), t(mixres), t(role), t(out_chan), t(filled),
        C=C, depth=16,
    ).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frames", [64, 62])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("depth", [20, 24, 32])
def test_finish_packed_hires_matches_jax(depth, C, frames):
    """Shift re-insert at 24/32 bits (bytes shifted 0, 1, 2 per lane, the
    same in both channels of a pair), the 20-bit << 4, 3-byte packing fused
    (F*C % 4 == 0) and not, and 4-byte output at 32 bits."""
    mix, mixbits, mixres, role, out_chan, filled = _inputs(C, depth + C + frames, F=frames)
    rng = np.random.default_rng(depth * C + frames)
    bs = np.repeat(rng.integers(0, 3, size=(B, 1)), C, axis=1).astype(np.int32)
    shift_vals = (
        rng.integers(0, 1 << 16, size=(frames, C, B)) & ((1 << (8 * bs.T[None])) - 1)
    ).astype(np.int32)
    j = jnp.asarray
    want = np.asarray(
        jax_finish_packed(
            j(mix), j(shift_vals), j(bs), j(mixbits), j(mixres), j(role), j(out_chan),
            j(filled), frames, C, depth,
        )
    )
    t = torch.from_numpy
    got = finish_packed(
        t(mix), t(shift_vals), t(bs), t(mixbits), t(mixres), t(role), t(out_chan), t(filled),
        C=C, depth=depth,
    ).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _layout_inputs(C, seed, frames):
    """As `_inputs`, with roles and output channels of the C-channel element
    layout; a fifth of the lanes carry singles only (every channel mono)."""
    rng = np.random.default_rng(seed)
    mix, mixbits, mixres, _, _, filled = _inputs(1, seed, F=frames)
    mix = rng.integers(-(2**23), 2**23, size=(frames, C * B), dtype=np.int64).astype(np.int32)
    mix[:, :3] = rng.integers(-(2**31), 2**31 - 1, size=(frames, 3))
    mixbits = rng.integers(0, 32, size=(B, C)).astype(np.int32)
    mixres = rng.integers(-128, 128, size=(B, C)).astype(np.int32)
    mixres[:4] = 0
    role = np.zeros((B, C), np.int32)
    out_chan = np.zeros((B, C), np.int32)
    c = 0
    for width in element_layout(C):
        out_chan[:, c] = CHANNEL_LAYOUT_OFFSETS[C - 1][c]
        if width == 2:
            role[:, c], role[:, c + 1] = 1, 2
            out_chan[:, c + 1] = out_chan[:, c] + 1
        c += width
    singles = np.arange(B) % 5 == 0
    role[singles] = 0
    out_chan[singles] = np.array(CHANNEL_LAYOUT_OFFSETS[C - 1], np.int32)
    filled = (rng.random((B, C)) < 0.9).astype(np.int32)
    return mix, mixbits, mixres, role, out_chan, filled


@pytest.mark.parametrize("frames", [64, 63])
@pytest.mark.parametrize("C", [3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("depth", [16, 20, 24, 32])
def test_finish_packed_multichannel_matches_jax(depth, C, frames):
    """Every packing at C = 3..8: 16-bit pairs fused for even C, 3-byte
    samples fused (F*C % 4 == 0) and not, 4-byte samples; the shift
    re-insert with the same bytes shifted in both channels of a pair."""
    mix, mixbits, mixres, role, out_chan, filled = _layout_inputs(C, depth + C + frames, frames)
    rng = np.random.default_rng(depth * C + frames)
    bs = rng.integers(0, 3, size=(B, C)).astype(np.int32)
    bs = np.where(role == 2, np.roll(bs, 1, axis=1), bs)
    shift_vals = (
        rng.integers(0, 1 << 16, size=(frames, C, B)) & ((1 << (8 * bs.T[None])) - 1)
    ).astype(np.int32)
    j = jnp.asarray
    want = np.asarray(
        jax_finish_packed(
            j(mix), j(shift_vals), j(bs), j(mixbits), j(mixres), j(role), j(out_chan),
            j(filled), frames, C, depth,
        )
    )
    t = torch.from_numpy
    got = finish_packed(
        t(mix), t(shift_vals), t(bs), t(mixbits), t(mixres), t(role), t(out_chan), t(filled),
        C=C, depth=depth,
    ).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("C", [3, 6, 8])
def test_extract_shift_multichannel_matches_jax_kernel(C):
    """A reader per channel with bs > 0 that is not a pair's V, the V halves
    split from channel c - 1's fused read; lanes of singles, of pairs, and
    with no shift region at all; partial packets."""
    rng = np.random.default_rng(40 + C)
    Bx, W = 128, 3 * C * F // 4 + 40
    words = rng.integers(-(2**31), 2**31, size=(Bx, W), dtype=np.int64).astype(np.int32)
    _, _, _, role, _, _ = _layout_inputs(C, C, F)
    role = np.tile(role, (Bx // B + 1, 1))[:Bx]
    bs = np.repeat(rng.integers(0, 3, size=(Bx, 1)), C, axis=1).astype(np.int32)
    bs[:, -1] = rng.integers(0, 3, size=Bx)  # the last single has its own
    shift_base = np.zeros((Bx, C), np.int32)
    for c in range(C):
        shift_base[:, c] = 37 + 3 * F * 8 * (c if c == 0 or role[0, c] != 2 else c - 1)
    shift_base = np.where(role == 2, np.roll(shift_base, 1, axis=1), shift_base).astype(np.int32)
    ns = np.full(Bx, F, np.int32)
    ns[::7] = rng.integers(0, F, size=len(ns[::7]))
    j = jnp.asarray
    want = np.asarray(
        extract_shift_kernel(j(words), j(shift_base), j(bs), j(role), j(ns), F, C,
                             "pallas_interpret")
    )
    t = torch.from_numpy
    got = extract_shift(t(words), t(shift_base), t(bs), t(role), t(ns), F=F, C=C).numpy()
    assert got.shape == want.shape == (F, C, Bx) and got.dtype == want.dtype
    assert (got != 0).any(axis=(0, 2)).all()
    valid = (np.arange(F)[:, None, None] < ns[None, None, :])
    np.testing.assert_array_equal(got * valid, want * valid)
