"""dispatch_ms (ms, program layer): host ms a call in `program.run` besides
the fill (``alac.program.dispatch``'s own time: the lookup, the wait on the
previous clones, the graph replay's enqueue, the output clones, the cache's
settling), from the port's spans in the traced window."""

from benchmark.port_spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "alac.program.dispatch")
