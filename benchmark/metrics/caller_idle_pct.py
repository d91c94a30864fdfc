"""caller_idle_pct (%, device layer): the share of the traced window in which
a card is idle and the host is inside no top-level port span (the caller,
not the program, holds the card), averaged over the cards."""

from benchmark.port_spans import caller_idle_pct


def read(ctx):
    return caller_idle_pct(ctx)
