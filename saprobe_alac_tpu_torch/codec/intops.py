"""Fixed-width integer helpers with Go shift semantics.

The reference decoder does all hot-path arithmetic in Go's int32/uint32, where:
  - arithmetic wraps mod 2^32,
  - shift counts >= 32 saturate (left shift -> 0; unsigned right shift -> 0;
    signed right shift -> sign fill),
  - ``>>`` on signed values is arithmetic (floor).

These helpers replicate that exactly on Python ints.  Used by the scalar oracle;
the device path has its own vectorized equivalents in ops/torchint.py.
"""

from __future__ import annotations

_M32 = 0xFFFFFFFF
_SIGN32 = 0x80000000


def u32(x: int) -> int:
    """Wrap to unsigned 32-bit."""
    return x & _M32


def s32(x: int) -> int:
    """Wrap to signed 32-bit."""
    x &= _M32
    return x - 0x100000000 if x & _SIGN32 else x


def s16(x: int) -> int:
    """Wrap to signed 16-bit."""
    x &= 0xFFFF
    return x - 0x10000 if x & 0x8000 else x


def shl32(x: int, s: int) -> int:
    """Go ``uint32/int32 << s`` (result as unsigned 32-bit); s >= 32 yields 0."""
    if s >= 32:
        return 0
    return (x << s) & _M32


def sshr32(x: int, s: int) -> int:
    """Go signed ``int32 >> s`` (arithmetic); s >= 32 yields sign fill."""
    x = s32(x)
    if s >= 32:
        return -1 if x < 0 else 0
    return x >> s  # Python >> on signed int is arithmetic/floor.


def ushr32(x: int, s: int) -> int:
    """Go unsigned ``uint32 >> s``; s >= 32 yields 0."""
    if s >= 32:
        return 0
    return (x & _M32) >> s


def sext(x: int, bits: int) -> int:
    """Sign-extend the low ``bits`` bits of x, via Go ``(x << (32-bits)) >> (32-bits)``.

    With bits > 32 the Go shift count underflows to a huge uint32 and both
    shifts saturate, yielding 0 (reference predictor.go:46 with chanBits=33).
    """
    cs = u32(32 - bits)
    return sshr32(shl32(x, cs), cs)


def lead(x: int) -> int:
    """Leading zeros of a uint32 (reference golomb.go:69-71)."""
    return 32 - u32(x).bit_length()


def lg3a(x: int) -> int:
    """floor(log2(x+3)) via 31 - lead(x+3) (reference golomb.go:74-76)."""
    return 31 - lead(u32(x + 3))
