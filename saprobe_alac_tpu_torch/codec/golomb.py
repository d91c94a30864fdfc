"""Adaptive Golomb-Rice entropy decoding (scalar oracle).

Behavioral parity with reference internal/alac/golomb.go (itself a port of
Apple ag_dec.c).  The code is inherently bit-serial: each codeword's length
depends on its decoded value and on the adaptive mean state, so there is no
intra-block parallelism — the device path (ops/) parallelizes across packets.

Algorithm per sample (reference golomb.go:148-253):
  k     = min(lg3a(mean >> 9), kb); m = 2^k - 1
  prefix = count of leading ones at the cursor
  if prefix >= 9:  value = next `maxSize` raw bits          (escape)
  else:            consume prefix+1; if k != 1 read k bits v:
                   v >= 2 -> value = prefix*m + v - 1 (consume k)
                   v <  2 -> value = prefix*m         (consume k-1)
  signed residual: n = value + zmode; del = ((n+1)>>1) * (n odd ? -1 : +1)
  mean += pb*(value+zmode) - ((pb*mean) >> 9); clamp to 0xffff if value > 0xffff
  zero-run mode when mean*4 < 512: secondary Golomb code (16-bit variant) gives
  a run of zeros; mean resets to 0; zmode=1 for the next sample unless the run
  hit 65535.

Window-read note: the reference forms its 32-bit decode window as
``read32(bytePos) << (bitPos&7)`` — true stream bits in the top 32-(bitPos&7)
(>= 25) positions, zeros below.  Every decode step consumes at most
prefix(<=8)+1+k(<=16) = 25 top bits (escape: 9+16=25 in the 16-bit variant;
the 32-bit escape re-reads exactly), so substituting the true 32-bit window
(bitcursor.window32) is bit-equivalent.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import BitstreamOverrun, SampleOverrun
from .bitcursor import BitCursor, get_stream_bits, window32
from .intops import lead, lg3a, s32, u32

QB_SHIFT = 9
QUANT_BITS = 1 << QB_SHIFT  # 512
MMUL_SHIFT = 2
MDEN_SHIFT = QB_SHIFT - MMUL_SHIFT - 1  # 6
MOFF = 1 << (MDEN_SHIFT - 2)  # 16
BITOFF = 24
MAX_PREFIX_16 = 9
MAX_PREFIX_32 = 9
MAX_DATATYPE_16 = 16
N_MAX_MEAN_CLAMP = 0xFFFF
N_MEAN_CLAMP_VAL = 0xFFFF
MAX_ZERO_RUN = 65535


@dataclass
class AGParams:
    """Adaptive Golomb-Rice state (reference golomb.go:44-65)."""

    mb: int
    mb0: int
    pb: int
    kb: int
    wb: int
    qb: int
    fw: int
    sw: int
    max_run: int

    @classmethod
    def standard(cls, mb: int, pb: int, kb: int, fw: int, sw: int, max_run: int) -> "AGParams":
        """SetAGParams: wb = (1<<kb)-1, qb = 512 - pb (golomb.go:55-65)."""
        return cls(
            mb=u32(mb),
            mb0=u32(mb),
            pb=u32(pb),
            kb=u32(kb),
            wb=u32((1 << kb) - 1) if kb < 32 else 0xFFFFFFFF,
            qb=u32(QUANT_BITS - pb),
            fw=u32(fw),
            sw=u32(sw),
            max_run=u32(max_run),
        )


def _dyn_get_16(data: bytes, bitpos: int, m: int, k: int) -> tuple[int, int]:
    """Secondary Golomb decode for zero-run lengths (reference golomb.go:112-144).

    Returns (value, new_bitpos).
    """
    stream = window32(data, bitpos)
    pre = lead(u32(~stream))

    if pre >= MAX_PREFIX_16:
        pre = MAX_PREFIX_16
        bitpos += pre
        stream = u32(stream << pre)
        return stream >> (32 - MAX_DATATYPE_16), bitpos + MAX_DATATYPE_16

    bitpos += pre + 1
    stream = u32(stream << (pre + 1))
    v = stream >> (32 - k) if k > 0 else 0
    bitpos += k

    if v < 2:
        return u32(pre * m), bitpos - 1
    return u32(pre * m + v - 1), bitpos


def dyn_decomp(params: AGParams, cursor: BitCursor, num_samples: int, max_size: int) -> list[int]:
    """Entropy-decode ``num_samples`` prediction residuals at the cursor.

    Returns signed int32 residuals and advances the cursor by the consumed
    bits.  Raises BitstreamOverrun / SampleOverrun per reference semantics
    (golomb.go:168-170, 232-234).
    """
    data = cursor.data
    base_byte = cursor.bitpos >> 3  # reference slices input at Pos (byte granularity)
    start = cursor.bitpos & 7
    max_pos = (cursor.size - base_byte) * 8
    bitpos = start

    out = [0] * num_samples

    mean = params.mb0
    zmode = 0
    count = 0
    pb = params.pb
    kb = params.kb
    wb = params.wb

    base_bit = base_byte * 8

    while count < num_samples:
        if bitpos >= max_pos:
            raise BitstreamOverrun(f"entropy decode ran past packet end at bit {bitpos}")

        m = mean >> QB_SHIFT
        k = min(lg3a(m), kb)
        m = (1 << k) - 1

        stream = window32(data, base_bit + bitpos)
        value = lead(u32(~stream))

        if value >= MAX_PREFIX_32:
            value = get_stream_bits(data, base_bit + bitpos + MAX_PREFIX_32, max_size)
            bitpos += MAX_PREFIX_32 + max_size
        else:
            bitpos += value + 1
            if k != 1:
                stream = u32(stream << (value + 1))
                v = stream >> (32 - k) if k > 0 else 0
                if v >= 2:
                    value = u32(value * m + v - 1)
                    bitpos += k
                else:
                    value = u32(value * m)
                    bitpos += k - 1
                    if bitpos < 0:  # k==0 (kb==0 cookie): Go's uint32 bitPos wraps huge
                        raise BitstreamOverrun("bit position underflow (kb=0)")

        # Sign from LSB of (value + zmode): del = ((n+1)>>1) * (n odd ? -1 : +1).
        # All in wrapping 32-bit arithmetic (golomb.go:206-212).
        ndecode = u32(value + zmode)
        mult = -1 if ndecode & 1 else 1
        out[count] = s32(s32(u32(ndecode + 1) >> 1) * mult)
        count += 1

        # Adaptive mean update with clamp.
        mean = u32(pb * ndecode + mean - ((pb * mean & 0xFFFFFFFF) >> QB_SHIFT))
        if value > N_MAX_MEAN_CLAMP:
            mean = N_MEAN_CLAMP_VAL

        zmode = 0

        # Zero-run mode.
        if u32(mean << MMUL_SHIFT) < QUANT_BITS and count < num_samples:
            zmode = 1
            k32 = max(lead(mean) - BITOFF + ((mean + MOFF) >> MDEN_SHIFT), 0)
            mz = ((1 << k32) - 1) & wb
            value, bitpos = _dyn_get_16(data, base_bit + bitpos, mz, k32)
            bitpos -= base_bit

            if count + value > num_samples:
                raise SampleOverrun(f"zero run of {value} exceeds {num_samples - count} remaining")

            # out[count:count+value] are already zero.
            count += value
            if value >= MAX_ZERO_RUN:
                zmode = 0
            mean = 0

    cursor.advance(bitpos - start)
    return out
