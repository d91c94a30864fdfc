"""download_ms (ms, batch layer): host ms a call in ``alac.batch.download``
(the wide-lane check, the error and length readbacks, the packed copy into
the pinned buffer: where a caller that did not synchronise waits for the
card; a 32-tap retry's submit inside it is not counted), from the port's
spans in the traced window."""

from benchmark.port_spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "alac.batch.download")
