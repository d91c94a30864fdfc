"""The port's Golomb-Rice encoder (plain version) against the JAX package's.

The same residuals, made from a seed with numpy, go through the JAX
package's encode kernel in interpret mode (`dense_encode_pallas`) and its
XLA lockstep encoder (`_entropy_encode`), and through the port's
`dense_encode` on CPU tensors.  Tolerance 0: equal ``bits`` on every lane,
equal words up to ``bits``, and in the port's output zero past them (its
callers add whole rows into a packet).  The regimes are those of
tests/test_encode_kernel.py, plus escape suffixes of 32 bits and kb = 28,
which the TPU kernel's quotient ladder cannot take (XLA only).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from saprobe_alac_tpu.ops.encode_device import _entropy_encode, _zero_run_table
from saprobe_alac_tpu.ops.encode_kernel import MAX_KB, dense_encode_pallas
from saprobe_alac_tpu_torch import interop
from saprobe_alac_tpu_torch.ops.encode_kernel import dense_encode

B = 128


def _mixed(F, cb=17):
    """Four content regimes in lane ranges: small residuals (adaptive k),
    dense zero runs (golomb.go:223-246), all zero (the 65535-run code and
    zmode), large values (escape prefix and a cb-wide suffix); partial and
    empty packets."""
    rng = np.random.default_rng(42)
    res = np.zeros((B, F), np.int64)
    res[:32] = rng.integers(-50, 50, (32, F))
    res[32:64] = np.where(rng.random((32, F)) < 0.7, 0, rng.integers(-30, 30, (32, F)))
    half = 1 << (cb - 2)
    res[96:] = rng.integers(-half, half, (32, F))
    ns = np.full(B, F, np.int32)
    ns[[10, 40, 70]] = [17, 3, 0]
    return res, ns


def _uniform(F, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, (B, F)), np.full(B, F, np.int32)


#: name -> (residuals and ns, pb, cb, mb, kb)
CASES = {
    "mixed": (lambda: _mixed(64), 40, 17, 10, 14),
    "mixed_cb32": (lambda: _mixed(64, 32), 40, 32, 10, 14),
    "tuning_pb10_kb10": (lambda: _uniform(32, -500, 500, 1), 10, 25, 40, 10),
    "kb1": (lambda: _uniform(32, -3, 3, 2), 40, 17, 10, 1),
    "kb25": (lambda: _uniform(32, -(2**20), 2**20, 3), 40, 24, 10, 25),
    "kb28": (lambda: _uniform(32, -(2**30), 2**30, 4), 40, 32, 10, 28),
}


def _jax_xla(res, zrun, ns, pb, cb, mb, kb, W):
    words, bits = _entropy_encode(
        jnp.zeros((B, W), jnp.int32), jnp.zeros(B, jnp.int32), res, zrun, jnp.ones(B, bool),
        jnp.full(B, pb, jnp.int32), jnp.full(B, cb, jnp.int32), ns, mb, kb,
    )
    return np.asarray(words), np.asarray(bits)


def _jax_pallas(res, zrun, ns, pb, cb, mb, kb, W):
    F = res.shape[1]
    n = jnp.where(res >= 0, 2 * res, -2 * res - 1)
    zr1 = jnp.concatenate(
        [jnp.minimum(zrun[:, 1:], 65535), jnp.zeros((B, 1), jnp.int32)], axis=1
    )
    words, bits, ovf = dense_encode_pallas(
        n.T, zr1.T, jnp.ones(B, bool), jnp.full(B, pb, jnp.int32), jnp.full(B, cb, jnp.int32),
        ns, jnp.full(B, mb, jnp.int32), kb=kb, F=F, W_out=W, LB=B, interpret=True,
    )
    assert not np.asarray(ovf).any()
    return np.asarray(words), np.asarray(bits)


#: Every case against the XLA encoder; against the TPU kernel where it takes kb.
PAIRS = [(case, "xla") for case in CASES] + [
    (case, "pallas_interpret") for case, spec in CASES.items() if spec[4] <= MAX_KB
]


@pytest.mark.parametrize("case,ref", PAIRS)
def test_dense_encode_matches_jax(case, ref):
    make, pb, cb, mb, kb = CASES[case]
    res_np, ns_np = make()
    F = res_np.shape[1]
    res, ns = jnp.asarray(res_np, jnp.int32), jnp.asarray(ns_np)
    zrun = _zero_run_table(res, ns)
    W = (F * (9 + max(kb, cb) + 26) + 256) // 32 + 8
    ref_fn = _jax_xla if ref == "xla" else _jax_pallas
    want_w, want_bits = ref_fn(res, zrun, ns, pb, cb, mb, kb, W)

    args = interop.encode_inputs_from_jax(
        res_np, np.asarray(zrun), np.full(B, pb, np.int32), cb, ns_np, mb
    )
    words, bits, ovf = (t.numpy() for t in dense_encode(*args, kb=kb, F=F, W_out=W))
    assert not ovf.any()
    assert np.array_equal(bits, want_bits)
    assert bits.max() > 2 * F and (bits[ns_np == 0] == 0).all()
    # Equal up to each lane's last bit, and zero past it.
    col = np.arange(W)[None, :] * 32
    keep = np.clip(bits[:, None] - col, 0, 32)  # bits of each word inside the stream
    mask = np.where(keep == 0, 0, (-1 << (32 - keep)) & 0xFFFFFFFF).astype(np.uint32)
    got_u, want_u = words.view(np.uint32), want_w[:, :W].view(np.uint32)
    assert np.array_equal(got_u & mask, want_u & mask)
    assert not (got_u & ~mask).any()


def test_dense_encode_rejects_kb_out_of_range():
    """kb == 0 streams belong to the host encoder; past 32, kb acts as 32
    (the run mask is 32 bits wide and k never reaches it)."""
    res_np, ns_np = _uniform(8, -300, 300, 5)
    args = interop.encode_inputs_from_jax(
        res_np, np.zeros_like(res_np), np.full(B, 40, np.int32), 17, ns_np, 10
    )
    for kb in (0, -1):
        with pytest.raises(ValueError):
            dense_encode(*args, kb=kb, F=8, W_out=64)
    at32, at200 = (dense_encode(*args, kb=kb, F=8, W_out=64) for kb in (32, 200))
    assert all(np.array_equal(a.numpy(), b.numpy()) for a, b in zip(at32, at200))
