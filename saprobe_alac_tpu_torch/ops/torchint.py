"""Fixed-width integer helpers with Go shift semantics (PyTorch).

Counterpart of saprobe_alac_tpu/ops/jaxint.py.  Values are 32-bit patterns
held in integer tensors.  PyTorch has almost no uint32 arithmetic, so every
helper computes in int64 (``& 0xFFFFFFFF`` for the unsigned view) and wraps
the result back into the signed int32 range, returning the input's dtype.
Shift counts of 32 or more (or negative, which Go's uint32 counts make huge)
give 0, or sign fill for the arithmetic right shift.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _long(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.tensor(x, dtype=torch.int64)


def wrap(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the signed int32 value with the same low 32 bits (int64)."""
    return ((v + 0x80000000) & _M32) - 0x80000000


def u(x) -> torch.Tensor:
    """The unsigned 32-bit view of ``x`` as int64 in [0, 2**32)."""
    return _long(x) & _M32


def _like(v: torch.Tensor, x) -> torch.Tensor:
    dtype = x.dtype if isinstance(x, torch.Tensor) else torch.int32
    return wrap(v).to(dtype)


def _bad(n):
    """(count out of range, count clamped to 0..31): tensors for a tensor
    count, Python values for a Python int, so a constant count makes no host
    tensor (a CUDA op would copy it to the card, which a CUDA graph capture
    refuses)."""
    if isinstance(n, torch.Tensor):
        n = n.to(torch.int64)
        return (n >= 32) | (n < 0), n.clamp(0, 31)
    return not 0 <= n < 32, min(max(n, 0), 31)


def _pick(cond, a, b):
    """``torch.where(cond, a, b)``; for a Python ``cond``, ``a`` (0 a zero
    tensor like ``b``) or ``b``."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    if not cond:
        return b
    return torch.zeros_like(b) if isinstance(a, int) and a == 0 else a


def shl(x, n):
    """Go ``<< n`` on 32-bit values; n >= 32 yields 0."""
    bad, nc = _bad(n)
    v = (u(x) << nc) & _M32
    return _like(_pick(bad, 0, v), x)


def ushr(x, n):
    """Go unsigned ``>> n``; n >= 32 yields 0."""
    bad, nc = _bad(n)
    return _like(_pick(bad, 0, u(x) >> nc), x)


def sshr(x, n):
    """Go signed arithmetic ``>> n``; n >= 32 yields sign fill."""
    bad, nc = _bad(n)
    return _like(wrap(_long(x)) >> _pick(bad, 31, nc), x)


def sext(x, bits):
    """Go ``(x << (32-bits)) >> (32-bits)``; bits > 32 yields 0."""
    cs = 32 - (bits.to(torch.int64) if isinstance(bits, torch.Tensor) else bits)
    return _like(_pick(cs < 0, 0, _long(sshr(shl(_long(x), cs), cs))), x)


def sext16(x):
    """Wrap to signed 16-bit."""
    return sshr(shl(x, 16), 16)


def clz(x):
    """Leading zeros of the 32-bit pattern (32 for 0)."""
    v = u(x)
    n = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        big = v >= (1 << s)
        v = torch.where(big, v >> s, v)
        n = n + torch.where(big, s, 0)
    bitlen = n + (v > 0).to(torch.int64)
    return _like(32 - bitlen, x)


def lg3a(x):
    """floor(log2(x+3)) on the 32-bit pattern (golomb.go:74-76)."""
    return _like(31 - _long(clz(wrap(_long(x) + 3))), x)
