"""Carry module inputs and outputs between the JAX package and the port.

All functions take numpy arrays (``np.asarray`` of JAX arrays) and return
CPU torch tensors, so one implementation's walk output can feed the other's
LPC, and one's encoder inputs the other's kernels, in the differential
tests.  No JAX import here.
"""

from __future__ import annotations

import numpy as np
import torch

from .encoder.spec import ChannelSpec, EncoderSpec
from .ops.walk import WalkResult
from .ops.walk_kernel import f_pad


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.int32))  # a writable copy


def walk_result_from_jax(w, F: int, C: int) -> WalkResult:
    """A saprobe_alac_tpu WalkResult -> the port's WalkResult.

    ``w.res`` is either the fused layout's raw rows buffer
    (passes*F_pad, NB, SL, 128), lane = nb*LB + sl*128 + l, or the slot
    loop's (F, C, B) channel planes; both become (passes, F_pad, B)."""
    res = np.asarray(w.res)
    if res.ndim == 4:
        passes = 2 if C > 1 else 1
        rows = res.reshape(passes, res.shape[0] // passes, -1)
    else:
        planes = np.moveaxis(res, 1, 0)  # (C, F, B)
        rows = np.zeros((C, f_pad(F), planes.shape[2]), np.int32)
        rows[:, :F] = planes
    fields = {name: _t(getattr(w, name)) for name in WalkResult._fields if name != "res"}
    return WalkResult(res=_t(rows), **fields)


def lpc_inputs_from_jax(res_t, order, mode, den, cb, ns, coefs, F: int):
    """Arguments of JAX `_lpc_batch` (res_t (F, L), lane arrays (L,),
    coefs (L, 32)) -> the port's `lpc_batch` arguments, res as (1, F_pad, L)."""
    res_t = np.asarray(res_t)
    rows = np.zeros((1, f_pad(F), res_t.shape[1]), np.int32)
    rows[0, :F] = res_t
    return (_t(rows), _t(order), _t(mode), _t(den), _t(cb), _t(ns), _t(coefs))


def encoder_spec_from_jax(spec) -> EncoderSpec:
    """A saprobe_alac_tpu EncoderSpec -> the port's, field by field, so the
    tests hand both packages the same choices."""

    def channel(ch) -> ChannelSpec:
        return ChannelSpec(
            order=ch.order, den_shift=ch.den_shift, pb_factor=ch.pb_factor, mode=ch.mode,
            coefs=list(ch.coefs), fit=ch.fit, pb_candidates=tuple(ch.pb_candidates),
        )

    return EncoderSpec(
        channel=channel(spec.channel),
        elements=None if spec.elements is None else [channel(e) for e in spec.elements],
        mix_bits=spec.mix_bits, mix_res=spec.mix_res, bytes_shifted=spec.bytes_shifted,
        escape=spec.escape, auto_escape=spec.auto_escape, use_lfe_tag=spec.use_lfe_tag,
    )


def lpc_forward_inputs_from_jax(x, order: int, den_shift: int, cb: int, ns, coefs,
                                mode: int, F: int):
    """Arguments of JAX `_lpc_forward` (x (B, F), ns (B,), coefs (B, 32);
    order 1..30) -> the port's `lpc_fir(..., forward=True)` arguments as the
    port's `_lpc_forward` builds them: rows (1, F_pad, B), the seven lane
    vectors, coefs (B, taps), and ``taps``."""
    x = np.asarray(x)
    B = x.shape[0]
    rows = np.zeros((1, f_pad(F), B), np.int32)
    rows[0, :F] = x.T
    taps = 9 if order <= 8 else 32
    ones = np.ones(B, np.int32)
    lane = (ones, ones * order, ones * den_shift, ones * cb, np.asarray(ns),
            ones * int(order not in (4, 5, 6, 8)), ones * int(mode != 0))
    return (_t(rows), *(_t(v) for v in lane), _t(np.asarray(coefs)[:, :taps])), taps


def encode_inputs_from_jax(res, zrun, pb_local, cb: int, ns, mb: int):
    """Residuals (B, F), their zero-run table (B, F) and lane values as JAX
    `_entropy_body` has them -> the port's `dense_encode` arguments as it
    builds them: n_t and zr1_t (F, B), act, pb_local, max_size, ns, mb."""
    res = np.asarray(res, np.int64)
    zrun = np.asarray(zrun)
    B = res.shape[0]
    n = np.where(res >= 0, 2 * res, -2 * res - 1).astype(np.uint32).astype(np.int32)
    zr1 = np.concatenate([np.minimum(zrun[:, 1:], 65535), np.zeros((B, 1), zrun.dtype)], axis=1)
    ones = np.ones(B, np.int32)
    return (_t(np.ascontiguousarray(n.T)), _t(np.ascontiguousarray(zr1.T)), _t(ones),
            _t(pb_local), _t(ones * cb), _t(ns), _t(ones * mb))


def dense_entropy_inputs_from_jax(words_t, bitpos, act, pb_local, max_size, ns, size_bits, mb,
                                  act2=None, pb2=None):
    """Arguments of JAX `dense_entropy_pallas` (words_t (W_pad, B) word-major,
    lane arrays (B,)) -> the port's `dense_entropy` arguments: words (B, W)
    row-major, then the lane vectors in the same order."""
    words = _t(np.ascontiguousarray(np.asarray(words_t).T))
    lane = [bitpos, act, pb_local, max_size, ns, size_bits, mb]
    lane += [np.zeros_like(np.asarray(act)) if act2 is None else act2,
             np.zeros_like(np.asarray(pb_local)) if pb2 is None else pb2]
    return (words, *(_t(np.asarray(x)) for x in lane))


def dense_entropy_rows_from_jax(rows, F: int, passes: int) -> torch.Tensor:
    """Rows of JAX `dense_entropy_pallas`, (passes * F_pad', B) with its own
    row padding, -> the port's (passes, F_pad, B)."""
    rows = np.asarray(rows)
    per = rows.reshape(passes, rows.shape[0] // passes, -1)
    out = np.zeros((passes, f_pad(F), per.shape[2]), np.int32)
    n = min(per.shape[1], out.shape[1])
    out[:, :n] = per[:, :n]
    return _t(out)
