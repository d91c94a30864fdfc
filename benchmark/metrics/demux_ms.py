"""demux_ms (ms, container layer): host ms a file in ``alac.service.demux``
(`demux_stream` and the reads of the file's packets from its container),
its own time over the files the traced window completed (its
``alac.service.join`` spans), from the port's spans."""

from benchmark.metrics.join_ms import per_file_ms


def read(ctx):
    return per_file_ms(ctx, "alac.service.demux")
