"""Phase 2: lane setup for the LPC kernel.

Counterpart of the kernel branch of saprobe_alac_tpu/ops/lpc.py
(`_lpc_batch`, lpc.py:99-210).  Lanes are (packet, channel) pairs,
channel-major (lane = c*B + b); the kernel reads the walk's rows in place,
so there is no merge and no relayout between the two kernels.
"""

from __future__ import annotations

import torch

from .lpc_kernel import lpc_fir

#: Orders whose reference kernels keep int32 coefficient accumulation
#: (predictor.go:99-618); every other order wraps coefficients to int16.
_INT32_ORDERS = (4, 5, 6, 8)


def lpc_lanes(order, mode, den, cb, ns, coefs):
    """Per-lane kernel inputs (fir_code, order, den, cb, ns, wrap16, mode,
    coefs), all contiguous int32.  Order 31 becomes class 2: a fixed order-1
    FIR with coef 1, den 0 and no adaptation (predictor.go:63-73)."""
    i32 = torch.int32
    is_delta = order == 31
    is_fir = (order >= 1) & (order <= 30)
    wrap16 = torch.ones_like(order, dtype=torch.bool)
    for o in _INT32_ORDERS:
        wrap16 &= order != o
    e0 = torch.zeros_like(coefs)
    e0[:, 0] = 1
    lanes = (
        is_fir.to(i32) + 2 * is_delta.to(i32),
        torch.where(is_delta, 1, order),
        torch.where(is_delta, 0, den),
        cb.clamp(min=1),
        ns,
        wrap16,
        mode,
        torch.where(is_delta[:, None], e0, coefs),
    )
    return tuple(x.to(i32).contiguous() for x in lanes)


def lpc_batch(res, order, mode, den, cb, ns, coefs, *, F, taps):
    """Reconstruct samples for all lanes.

    res: (P, F_src, S) residual rows (see lpc_kernel); order, mode, den, cb,
    ns: (L,) int32; coefs: (L, 32) int32, zero beyond each lane's order.
    Returns (F, L) int32 channel samples."""
    lanes = lpc_lanes(order, mode, den, cb, ns, coefs)
    return lpc_fir(res, *lanes, F=F, taps=taps)[:F]
