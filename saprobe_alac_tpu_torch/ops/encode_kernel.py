"""Encode kernel: adaptive Golomb-Rice entropy encode, one packet per lane.

Counterpart of saprobe_alac_tpu/ops/encode_kernel.py `dense_encode_pallas`
(`_encode_kernel`).  `dense_encode` launches the CUDA kernel
(csrc/encode_kernel.cu) for CUDA tensors and runs the plain PyTorch version,
`dense_encode_reference`, for CPU tensors.

Inputs, as the TPU kernel takes them: ``n_t`` (F, R) int32 zigzagged
residuals (2d for d >= 0, -2d-1 below, wrapping; read as uint32) and
``zr_t`` (F, R) the zero run that starts at the NEXT sample
(zrun[t + 1], clipped to 65535, don't-care past ns); per lane ``act``,
``pb_local``, ``max_size`` (the escape suffix width, 1..32), ``ns`` (<= F)
and ``mb``.  ``row`` (L,) maps each lane to its residual row, so one call
codes every channel of an element under every pbFactor candidate (lanes
differ in row and pb_local, no row is copied); without it lane l codes row
l (L = R), and a lane whose row lies outside [0, R) codes nothing.
Returns ``(words (L, W_out) int32, bits (L,), ovf (L,))``:
each lane's stream from bit 31 of its word 0 (big-endian bit order), every
bit past ``bits`` zero (callers add whole rows into a packet at a bit
offset); inactive lanes and ``ns == 0`` report 0 bits.  ``ovf`` flags a
stream longer than the row, which a ``W_out`` sized for the worst case
(9 + max(kb, max_size) + 26 bits per sample) rules out.  Any kb > 0
(past 32 it acts as 32).
Parity: the inverse of golomb.go:112-253, as encode_device.py:230-311.
"""

from __future__ import annotations

import torch

from .. import _build
from .torchint import clz, lg3a, shl, u, wrap

_M32 = 0xFFFFFFFF


def dense_encode(n_t, zr_t, act, pb_local, max_size, ns, mb, *, kb, F, W_out, row=None):
    if kb < 1:
        raise ValueError(f"kb must be positive, got {kb}")
    kb = min(kb, 32)  # k never passes 23 and the run mask is 32 bits wide
    lane = (act, pb_local, max_size, ns, mb)
    if n_t.device.type == "cpu":
        return dense_encode_reference(n_t, zr_t, *lane, kb=kb, F=F, W_out=W_out, row=row)
    if n_t.device.type != "cuda":
        raise ValueError(f"no encode kernel for device {n_t.device}")
    R, L = n_t.shape[1], act.shape[0]
    if row is None and L != R:
        raise ValueError(f"{L} lanes for {R} rows need a row map")
    names = ("n_t", "zr_t", "act", "pb_local", "max_size", "ns", "mb", "row")
    for name, t in zip(names, (n_t, zr_t, *lane, row)):
        if t is None:
            continue
        if t.device != n_t.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous int32 on {n_t.device}")
        want = (F, R) if name in ("n_t", "zr_t") else (L,)
        if t.shape != want:
            raise ValueError(f"{name}: want shape {want}, got {tuple(t.shape)}")
    # The kernel stores only the words it fills: the zero tails are these.
    words = torch.zeros((L, W_out), dtype=torch.int32, device=n_t.device)
    bits = torch.empty(L, dtype=torch.int32, device=n_t.device)
    ovf = torch.empty(L, dtype=torch.int32, device=n_t.device)
    lib = _build.load()
    with torch.cuda.device(n_t.device):
        stream = torch.cuda.current_stream(n_t.device).cuda_stream
        rc = lib.alac_encode_launch(
            n_t.data_ptr(), zr_t.data_ptr(), None if row is None else row.data_ptr(), R,
            *(t.data_ptr() for t in lane), words.data_ptr(), bits.data_ptr(), ovf.data_ptr(),
            L, F, W_out, kb, stream,
        )
    if rc != 0:
        raise RuntimeError(f"encode kernel launch failed: CUDA error {rc}")
    _build.count_launch("encode")
    return words, bits, ovf


def _emit(words, bitpos, value, width):
    """Append ``width`` (0..32) bits of ``value`` at per-lane ``bitpos`` of
    zero-initialised ``words`` (B, W) int32: every bit is new, so two
    scatter-adds onto the straddled words do it.  In place; returns
    bitpos + width.  A lane past the row adds onto the last words."""
    W = words.shape[1]
    width = width.clamp(0, 32)
    v = u(value) & ((torch.ones_like(width) << width) - 1)
    # The value in a 64-bit window over words widx and widx + 1, MSB first
    # (a shift of 64 arises only at width 0, where v is 0).
    win = v << (64 - (bitpos & 31) - width).clamp(max=63)
    widx = (bitpos >> 5).clamp(0, W - 2)[:, None]
    words.scatter_add_(1, widx, wrap((win >> 32) & _M32).to(torch.int32)[:, None])
    words.scatter_add_(1, widx + 1, wrap(win & _M32).to(torch.int32)[:, None])
    return bitpos + width


def _rice_code(words, bitpos, on, value, m, k, esc_bits):
    """One Golomb codeword per lane where ``on``: ``value`` (uint32 view)
    against divisor m = 2^k - 1 (a signed m <= 0 forces the escape), the
    escape suffix ``esc_bits`` wide.  Returns the new bitpos."""
    qu = value // m.clamp(min=1)
    escape = (m <= 0) | (qu >= 9)
    q = torch.where(escape, 9, qu)
    p_w = torch.where(escape, 9, q + 1)
    p_v = torch.where(escape, 0x1FF, (torch.ones_like(q) << (q + 1)) - 2)  # q ones, a zero
    r = (value - q * m) & _M32
    sfx_w = torch.where(escape, esc_bits, torch.where(k == 1, 0, torch.where(r == 0, k - 1, k)))
    sfx_v = torch.where(escape, value, torch.where(r == 0, 0, r + 1))
    bitpos = _emit(words, bitpos, p_v, torch.where(on, p_w, 0))
    return _emit(words, bitpos, sfx_v, torch.where(on, sfx_w, 0))


def dense_encode_reference(n_t, zr_t, act, pb_local, max_size, ns, mb, *, kb, F, W_out,
                           row=None):
    """Plain PyTorch encoder: the lockstep loop of encode_device.py:230-311,
    every live lane coding one sample (and the zero run after it) per step.
    Internals run in int64 holding uint32 views."""
    I = torch.int64
    R, B = n_t.shape[1], act.shape[0]
    dev = n_t.device
    col = torch.arange(B, device=dev) if row is None else row.to(I)
    inside = (col >= 0) & (col < R)
    col = col.clamp(0, max(R - 1, 0))[None, :]
    wb = (1 << kb) - 1 if kb < 32 else _M32
    nsl = ns.to(I).clamp(max=F)
    pb = u(pb_local)
    esc_bits = max_size.to(I)
    # Two words of slack: _emit clamps to the last pair, which is cut off.
    words = torch.zeros((B, W_out + 2), dtype=torch.int32, device=dev)
    bitpos = torch.zeros(B, dtype=I, device=dev)
    i = torch.zeros(B, dtype=I, device=dev)
    mean = u(mb)
    zmode = torch.zeros(B, dtype=I, device=dev)
    live = (act != 0) & (nsl > 0) & inside
    sixteen = torch.full((B,), 16, dtype=I, device=dev)
    for _ in range(F):
        if not bool(live.any()):
            break
        at = i.clamp(max=F - 1)[None, :]
        n = u(n_t[at, col][0])
        value = (n - zmode) & _M32
        k = lg3a(mean >> 9).clamp(max=kb)
        m = wrap(u(shl(torch.ones_like(k), k)) - 1)
        bitpos = _rice_code(words, bitpos, live, value, m, k, esc_bits)
        i = torch.where(live, i + 1, i)
        mean_n = (pb * n + mean - (((pb * mean) & _M32) >> 9)) & _M32
        mean_n = torch.where(value > 0xFFFF, 0xFFFF, mean_n)
        mean = torch.where(live, mean_n, mean)
        zmode = torch.where(live, 0, zmode)

        # Zero-run mode (the mirror of golomb.go:223-246).
        zcond = live & (((mean << 2) & _M32) < 512) & (i < nsl)
        k32 = (clz(mean) - 24 + (((mean + 16) & _M32) >> 6)).clamp(min=0)
        mz = u(shl(torch.ones_like(k32), k32) - 1) & wb
        run = zr_t[at, col][0].to(I).clamp(0, 65535)
        bitpos = _rice_code(words, bitpos, zcond, run, wrap(mz), k32, sixteen)
        i = torch.where(zcond, i + run, i)
        zmode = torch.where(zcond, (run < 65535).to(I), zmode)
        mean = torch.where(zcond, 0, mean)
        live = live & (i < nsl)
    bits = bitpos.to(torch.int32)
    return words[:, :W_out], bits, (bitpos > 32 * W_out).to(torch.int32)
