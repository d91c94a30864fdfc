"""Adaptive LPC predictor reconstruction (scalar oracle).

Behavioral parity with reference internal/alac/predictor.go (port of dp_dec.c).

The recurrence is strictly serial per channel: out[i] depends on
out[i-1..i-order] AND on coefficients mutated at every prior sample (the
sign-walk adaptation), so it cannot be a parallel scan — the device path
parallelizes across (packet, channel) lanes instead (ops/lpc.py).

Modes (predictor.go:45-94):
  order 0            -> copy residuals
  order 31           -> first-order delta decode
  order 1..30, 32    -> warm-up deltas for the first `order` samples, then the
                        adaptive FIR recurrence

Int-width subtlety replicated here: the reference's specialized kernels for
orders 4/5/6/8 (predictor.go:99-618) keep coefficients in int32 locals for the
whole block — coefficient adaptation does NOT wrap at int16 mid-block — while
the general path (predictor.go:623-684) stores back into the int16 coef array
at every step.  `wrap16` captures this.
"""

from __future__ import annotations

from .intops import s16, s32, sext, sshr32

MAX_COEFS = 32
NUM_ACTIVE_DELTA = 31
UNUSED_HEADER_BITS = 12

#: Orders decoded with int32 (non-wrapping) coefficient accumulation.
_INT32_COEF_ORDERS = frozenset({4, 5, 6, 8})


def sign_of_int(val: int) -> int:
    """+1 / 0 / -1 (reference predictor.go:35-39)."""
    if val > 0:
        return 1
    if val < 0:
        return -1
    return 0


def unpc_block(
    pc1: list[int],
    num: int,
    coefs: list[int],
    num_active: int,
    chan_bits: int,
    den_shift: int,
) -> list[int]:
    """Reverse the linear prediction over one residual block.

    Returns the reconstructed samples (signed int32).  ``coefs`` is not
    mutated (a copy is adapted internally, mirroring per-packet coef reads).
    """
    if num <= 0:
        return []
    out = [0] * num
    out[0] = pc1[0]

    if num_active == 0:
        out[1:num] = pc1[1:num]
        return out

    if num_active == NUM_ACTIVE_DELTA:
        prev = out[0]
        for i in range(1, num):
            prev = sext(pc1[i] + prev, chan_bits)
            out[i] = prev
        return out

    # Warm-up: first `num_active` samples by cumulative delta (predictor.go:76-79).
    for i in range(1, min(num_active + 1, num)):
        out[i] = sext(pc1[i] + out[i - 1], chan_bits)

    lim = num_active + 1
    den_half = (1 << (den_shift - 1)) if den_shift > 0 else 0
    wrap16 = num_active not in _INT32_COEF_ORDERS
    c = [s32(x) for x in coefs[:num_active]]

    for idx in range(lim, num):
        top = out[idx - lim]

        # Prediction: sum over k of coef[k] * (out[idx-1-k] - top), then
        # (sum + denHalf) >> denShift in wrapping int32 (predictor.go:647-656).
        acc = 0
        for k in range(num_active):
            acc += c[k] * (out[idx - 1 - k] - top)
        sum1 = sshr32(s32(acc + den_half), den_shift)

        del_ = pc1[idx]
        del0 = del_
        sign = sign_of_int(del_)
        out[idx] = sext(del_ + top + sum1, chan_bits)

        # Coefficient adaptation: walk taps from highest index down, absorbing
        # the residual error; stop early when del0 crosses zero
        # (predictor.go:660-682).  Unified over both sign branches:
        #   coef[k] -= sign * sign(dd);  del0 -= w * ((sign*sign(dd)*dd) >> den)
        #   continue while sign*del0 > 0
        if sign != 0:
            for j in range(1, num_active + 1):  # weight j, tap k = num_active - j
                k = num_active - j
                dd = s32(top - out[idx - 1 - k])
                sgn = sign_of_int(dd) * sign
                nc = c[k] - sgn
                c[k] = s16(nc) if wrap16 else s32(nc)
                del0 = s32(del0 - j * sshr32(s32(sgn * dd), den_shift))
                if sign > 0 and del0 <= 0:
                    break
                if sign < 0 and del0 >= 0:
                    break

    return out
