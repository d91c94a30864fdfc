"""Bytes the shift-region reader (csrc/raw_reader_kernel.cu) needs for one
call, at 24 and 32 bits only: each active lane's fields once (a mono
channel reads ``8 * bytes_shifted`` bits a sample, a pair's U channel
``16 * bytes_shifted`` for both, its V channel nothing), the six inputs of
every (channel, packet) lane, and the output plane.  Frozen from
chip_smoke.py's `raw_bound` at commit
d146ec009c2c24691c94e65e7d8eb983445d6db9:

    (fields * step).sum() / 8 + 4 * 6 * L + 4 * out.numel()

Every element is counted as shifted, as the configuration states; an
escaped element would read none, so on music this counts what the inputs
need.
"""

#: Bits a sample reads per unit of bytes_shifted, by element.
STEP_BITS = {"SCE": 8, "LFE": 8, "CPE": 16}


def f_pad(F: int) -> int:
    return ((F + 15) // 16) * 16


def bytes_needed(s):
    if s.depth not in (24, 32) or s.bytes_shifted == 0:
        return None
    L = s.C * s.packets
    fields = s.samples * sum(STEP_BITS[e] for e in s.layout) * s.bytes_shifted / 8
    return fields + 4 * 6 * L + 4 * f_pad(s.F) * L
