"""raw_read_roofline (%, shift region layer): the raw reader's least
time (the bytes of roofline/raw_reader_kernel.py at the card's memory rate)
over its traced time."""

from benchmark.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "raw_reader_kernel")
