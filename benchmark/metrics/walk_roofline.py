"""walk_roofline (%, walk layer): the packet walk's least time (the
bytes of roofline/packet_kernel.py at the card's memory rate) over its
traced time."""

from benchmark.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "packet_kernel")
