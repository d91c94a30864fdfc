"""device_idle_pct (%, device layer): the share of the traced window in
which no kernel, copy or memset runs on a card, averaged over the cell's
cards."""

from benchmark.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
