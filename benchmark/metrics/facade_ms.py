"""facade_ms (ms, facade layer): host ms a crop in the facade's own code
(``alac.decoder.read``, ``alac.decoder.seek`` and ``alac.decoder.close``,
each its own time: the copies of the windows' PCM into what a read
returns, the seeks' state, a dropped window let go; not the packet reads
nor the batch calls inside them), from the port's spans in the traced
window; a crop as `open_ms` counts it."""

from benchmark.metrics.open_ms import per_crop_ms


def read(ctx):
    return per_crop_ms(ctx, "alac.decoder.read", "alac.decoder.seek", "alac.decoder.close")
