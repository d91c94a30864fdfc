"""lpc_roofline (%, LPC layer): the LPC decode's least time (the bytes
of roofline/lpc_kernel.py at the card's memory rate) over its traced
time."""

from benchmark.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "lpc_kernel")
