"""Bytes the LPC decode (csrc/lpc_kernel.cu) needs for one call: each
lane's residual plane in and its sample plane out, and its 7 scalars and 9
taps.  Frozen from chip_smoke.py's `walk_bounds` (the `lp` bound) at commit
d146ec009c2c24691c94e65e7d8eb983445d6db9:

    4 * (res.numel() + L * (7 + 9) + f_pad(F) * L),  L = C * B lanes
"""


def f_pad(F: int) -> int:
    return ((F + 15) // 16) * 16


def bytes_needed(s) -> float:
    L = s.C * s.packets
    return 4 * (f_pad(s.F) * L + L * (7 + 9) + f_pad(s.F) * L)
