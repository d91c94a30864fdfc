"""LPC kernel: adaptive LPC, one (packet, channel) per lane, in the decode
direction (reconstruction) and the encode direction (``forward=True``).

Counterpart of saprobe_alac_tpu/ops/lpc_kernel.py `lpc_fir_pallas`
(`_lpc_kernel`, both directions).  `lpc_fir` launches the CUDA kernel
(csrc/lpc_kernel.cu) for CUDA tensors and runs the plain PyTorch version,
`lpc_fir_reference`, for CPU tensors.

``res`` is (P, F_src, S) int32 with P*S == L lanes: lane l = c*S + s reads
row t of ``res[c, :, s]``.  The element kernel's rows (passes, F_pad, B)
are read in place this way (lane = c*B + b, channel-major), and a plain
(F_pad, L) residual array is passed as ``res[None]``.

Per lane: fir_code 0 passes the residual through (order 0, escape), 1 runs
the adaptive FIR, 2 runs order-31 delta as a fixed order-1 FIR with coef 1,
den 0 and no adaptation.  ``mode`` != 0 runs the two-stage delta pre-pass
first.  Returns out (F_pad, L) int32, F_pad = F rounded up to 16; rows at
t >= ns carry the residual (trimmed by the caller).  Parity: predictor.go:
45-684, decoder.go:307-309.

With ``forward=True`` the rows of ``res`` are the signal x[t] and the output
rows are its residuals: the history is fed the input, so only the
coefficients are carried; fir_code 0 lanes and rows at t == 0 or t >= ns pass
x through; ``mode`` != 0 runs the delta as a POST-pass on the residual row
(the stream carries delta'd residuals, which the decoder un-deltas first).
The encoder sends orders 1..30 here as class 1 and never class 2.
"""

from __future__ import annotations

import torch

from .. import _build
from .torchint import sext, sext16, shl, sshr, wrap
from .walk_kernel import f_pad

TAPS = (9, 32)


def lpc_fir(res, fir_code, order, den, cb, ns, wrap16, mode, coefs, *, F, taps, forward=False):
    """coefs: (L, 32) or (L, taps) int32 initial coefficients."""
    if taps not in TAPS:
        raise ValueError(f"taps must be 9 or 32, got {taps}")
    lane = (fir_code, order, den, cb, ns, wrap16, mode)
    if res.device.type == "cpu":
        return lpc_fir_reference(res, *lane, coefs, F=F, taps=taps, forward=forward)
    if res.device.type != "cuda":
        raise ValueError(f"no LPC kernel for device {res.device}")
    P, F_src, S = res.shape
    L = P * S
    Fp = f_pad(F)
    if Fp > F_src:
        raise ValueError(f"res has {F_src} rows per channel, need {Fp}")
    coefs_t = coefs[:, :taps].T.contiguous()
    for name, t in zip(("res", "lane", "coefs"), (res, *lane, coefs_t)):
        if t.device != res.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous int32 on {res.device}")
    if any(t.shape != (L,) for t in lane) or coefs_t.shape != (taps, L):
        raise ValueError(f"lane inputs must be ({L},), coefs ({L}, >= {taps})")
    out = torch.empty((Fp, L), dtype=torch.int32, device=res.device)
    fn = getattr(_build.load(), _build.lpc_entry(taps, forward))
    with torch.cuda.device(res.device):
        stream = torch.cuda.current_stream(res.device).cuda_stream
        rc = fn(
            res.data_ptr(), S, F_src, *(t.data_ptr() for t in lane),
            coefs_t.data_ptr(), out.data_ptr(), Fp, L, stream,
        )
    if rc != 0:
        raise RuntimeError(f"LPC kernel launch failed: CUDA error {rc}")
    _build.count_launch("lpc_forward" if forward else "lpc")
    return out


def _sign(x):
    return (x > 0).long() - (x < 0).long()


def lpc_fir_reference(res, fir_code, order, den, cb, ns, wrap16, mode, coefs, *, F, taps,
                      forward=False):
    """Plain PyTorch LPC: a loop over t with the (L, taps) history, as the
    kernel's row step (lpc_kernel.py:155-248), in either direction.
    Internals run in int64 holding int32 values, wrapped after every step
    that can overflow."""
    I = torch.int64
    P, F_src, S = res.shape
    L = P * S
    dev = res.device
    Fp = f_pad(F)
    # Lane-major view of the residual rows: (Fp, L) with lane = c*S + s.
    rs = res[:, :Fp, :].permute(1, 0, 2).reshape(Fp, L).to(I)
    fir, order, den, cb, ns = (x.to(I) for x in (fir_code, order, den, cb, ns))
    wrap16 = wrap16 != 0
    is_mode = mode != 0
    coefs = coefs[:, :taps].to(I).clone()

    k = torch.arange(taps, device=dev)[None, :]
    tmask = k < order[:, None]
    weight = order[:, None] - k
    den_half = torch.where(den > 0, shl(torch.ones_like(den), (den - 1).clamp(min=0)), 0)
    # top = hist[order]: a select over the history padded to a power of
    # two, as the kernel's select tree (indices past the taps read 0).
    p2 = 1 << (taps - 1).bit_length()
    tsel = order & (p2 - 1)
    in_hist = tsel < taps
    tsel = tsel.clamp(max=taps - 1)[:, None]

    hist = torch.zeros((L, taps), dtype=I, device=dev)  # hist[:, 0] = newest
    prev = torch.zeros(L, dtype=I, device=dev)
    out = torch.empty((Fp, L), dtype=torch.int32, device=dev)
    for t in range(Fp):
        delta_raw = rs[t]  # forward: the signal x[t]
        delta = delta_raw
        if not forward:
            # mode > 0 two-stage delta pre-pass (decoder.go:307-309).
            d0 = sext(wrap(prev + delta_raw), cb)
            delta = torch.where(is_mode & (t >= 1), d0, delta_raw)
            prev = torch.where(is_mode, delta, prev)

        active = (fir >= 1) & (t < ns) & (t >= 1)
        top = torch.where(in_hist, torch.gather(hist, 1, tsel)[:, 0], 0)

        # Prediction (predictor.go:647-656): wrapping int32 dot.
        diff = wrap(hist - top[:, None])
        acc = wrap((wrap(coefs * diff) * tmask).sum(1))
        sum1 = sshr(wrap(acc + den_half), den)
        warm = t <= order
        if forward:
            # The minimal representative of x - prediction mod 2^chan_bits,
            # then the mode > 0 delta post-pass on the residual row.
            fir_delta = sext(wrap(delta_raw - top - sum1), cb)
            warm_delta = sext(wrap(delta_raw - hist[:, 0]), cb)
            delta = torch.where(warm, warm_delta, fir_delta)
            r = torch.where(active, delta, delta_raw)
            row = torch.where(is_mode & (t >= 1), sext(wrap(r - prev), cb), r)
            prev = torch.where(is_mode, r, prev)
        else:
            fir_val = sext(wrap(delta + top + sum1), cb)
            warm_val = sext(wrap(delta + hist[:, 0]), cb)
            row = torch.where(active, torch.where(warm, warm_val, fir_val), delta)
        out[t] = row.to(torch.int32)

        # Coefficient adaptation (predictor.go:660-682): the sign walk as
        # predicated arithmetic over exclusive suffix sums of contributions.
        sign = _sign(delta)
        dd = wrap(top[:, None] - hist)
        sg = _sign(dd) * sign[:, None]
        contrib = torch.where(tmask, wrap(weight * sshr(wrap(sg * dd), den[:, None])), 0)
        T = wrap(contrib.flip(1).cumsum(1).flip(1) - contrib)
        del0 = wrap(delta[:, None] - T)
        run = torch.where(sign[:, None] > 0, del0 > 0, del0 < 0) & tmask
        adapt = (active & (fir == 1) & (sign != 0) & ~warm)[:, None] & run
        newc = wrap(coefs - sg)
        newc = torch.where(wrap16[:, None], sext16(newc), newc)
        coefs = torch.where(adapt, newc, coefs)

        fed = delta_raw if forward else row  # the encoder's history is its input
        hist = torch.cat([fed[:, None], hist[:, :-1]], dim=1)
    return out
