"""The port's epilogue against saprobe_alac_tpu/ops/epilogue.py.

Random reconstructed planes and per-lane metadata (mix shifts and weights,
roles, SMPTE channel slots, unfilled slots, bytes shifted and shift values)
go through both; the packed output must be equal bit for bit (tolerance 0),
for C = 1 and C = 2 at every depth, on the fused packings and on the
fallback (F*C not a multiple of 4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saprobe_alac_tpu.ops.epilogue import finish_packed as jax_finish_packed
from saprobe_alac_tpu_torch.ops.epilogue import finish_packed

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
