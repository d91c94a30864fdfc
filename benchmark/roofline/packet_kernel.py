"""Bytes the packet walk (csrc/packet_kernel.cu) needs for one call, each
input and output once: the packets' own bytes, each row's size and the
channel offsets, each lane's metadata and coefficients, and the residual
rows.  Frozen from chip_smoke.py's `packet_bound` at commit
d146ec009c2c24691c94e65e7d8eb983445d6db9:

    sizes.sum() / 8 + 4 * B * (1 + 2 + C * (14 + 32)) + 4 * C * f_pad(F) * B
"""


def f_pad(F: int) -> int:
    """Rows a lane's residual plane holds: F rounded up to 16."""
    return ((F + 15) // 16) * 16


def bytes_needed(s) -> float:
    B, C = s.packets, s.C
    return s.packet_bytes + 4 * B * (1 + 2 + C * (14 + 32)) + 4 * C * f_pad(s.F) * B
