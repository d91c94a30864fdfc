"""Carry module inputs and outputs between the JAX package and the port.

All functions take numpy arrays (``np.asarray`` of JAX arrays) and return
CPU torch tensors, so one implementation's walk output can feed the other's
LPC in the differential tests.  No JAX import here.
"""

from __future__ import annotations

import numpy as np
import torch

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
