"""trim_ms (ms, batch layer): host ms a call making each packet's PCM
`bytes` (``alac.batch.trim``, the `_to_bytes` loop), from the port's spans in
the traced window."""

from benchmark.port_spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "alac.batch.trim")
