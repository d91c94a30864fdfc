"""The port's forward LPC (plain version) against the JAX package's.

The same signal rows, made from a seed with numpy, go through the JAX
package's forward LPC kernel in interpret mode (`lpc_fir_pallas(...,
forward=True, interpret=True)`) and its XLA scan (`_lpc_forward` with
enc_impl="xla"), and through the port's `lpc_fir(..., forward=True)` and
`_lpc_forward` (both channels of a pair in one call) on CPU tensors.
Tolerance 0 (integer code).  Against the kernel every row is compared;
against the XLA scan rows t < ns, since past a packet's end the scan leaves
what the caller never reads.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import music_pcm

from saprobe_alac_tpu.ops import encode_device as jed
from saprobe_alac_tpu.ops.lpc_kernel import lpc_fir_pallas
from saprobe_alac_tpu_torch import interop
from saprobe_alac_tpu_torch.ops import encode_device as ted
from saprobe_alac_tpu_torch.ops.lpc_kernel import lpc_fir

F = 64
B = 128  # one lane block of the Pallas kernel


def _signal(cb, seed):
    """(B, F) signal rows that fit ``cb`` bits: music on most lanes,
    full-scale noise on every eighth (wrapping differences at 32 bits);
    ns full, partial and empty."""
    rng = np.random.default_rng(seed)
    depth = min(cb, 24)
    x = np.stack([music_pcm(F, 1, depth, seed=seed + b, tonality=0.9)[:, 0] for b in range(B)])
    half = 1 << (cb - 1)
    x[7::8] = rng.integers(-half, half, size=(B // 8, F))
    ns = np.full(B, F, np.int32)
    ns[3::8] = rng.integers(2, F, size=B // 8)
    ns[5] = 0
    coefs = np.zeros((B, 32), np.int32)
    return x.astype(np.int32), ns, coefs, rng


@pytest.mark.parametrize("mode,cb", [(0, 16), (1, 17), (0, 24), (1, 32)])
@pytest.mark.parametrize("order", [1, 4, 8, 9, 12, 30])
def test_forward_kernel_matches_jax_interpret(order, mode, cb):
    x, ns, coefs, rng = _signal(cb, 100 * order + cb)
    coefs[:, :order] = rng.integers(-2000, 2000, size=(B, order))
    args, taps = interop.lpc_forward_inputs_from_jax(x, order, 9, cb, ns, coefs, mode, F)
    got = lpc_fir(*args, F=F, taps=taps, forward=True)
    rows, *lane, coefs_t = (jnp.asarray(a.numpy()) for a in args)
    want = lpc_fir_pallas(
        rows[0], *lane, coefs_t.T, F=F, LB=B, taps=taps, interpret=True, forward=True
    )
    want = np.asarray(want)
    assert (want[:F] != x.T).any()
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode,cb", [(0, 16), (1, 17), (1, 32)])
@pytest.mark.parametrize("order", [0, 1, 4, 8, 9, 12, 30, 31])
def test_lpc_forward_matches_jax_xla(order, mode, cb):
    """`_lpc_forward` of both packages: orders 0 and 31 (tensor ops), 1..30
    (the kernel's plain version against the XLA scan).  The port's takes
    the two channels of a pair at once (one kernel launch for 1..30); the
    JAX package's, one channel a call."""
    chans = []
    for c in range(2):
        x, ns, coefs, rng = _signal(cb, 7 * order + cb + 1000 * c)
        coefs[:, :order] = rng.integers(-2000, 2000, size=(B, min(order, 32)))
        chans.append((x, coefs))
    got = ted._lpc_forward(
        [torch.from_numpy(x) for x, _ in chans], order, 9, cb, torch.from_numpy(ns),
        [torch.from_numpy(cf) for _, cf in chans], F, mode,
    )
    valid = np.arange(F)[None, :] < ns[:, None]
    assert valid.sum() > B * F // 2 and len(got) == 2
    for (x, coefs), g in zip(chans, got):
        want = jed._lpc_forward(
            jnp.asarray(x), order, 9, cb, jnp.asarray(ns), jnp.asarray(coefs), F, mode, "xla"
        )
        assert np.array_equal(np.where(valid, g.numpy(), 0), np.where(valid, np.asarray(want), 0))
