"""pack_ms (ms, batch layer): host ms a call in `_host_stage`
(``alac.batch.pack``: sizes, buckets, the C++ packer or the tight copy), from
the port's spans in the traced window."""

from benchmark.port_spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "alac.batch.pack")
