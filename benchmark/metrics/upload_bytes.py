"""upload_bytes (bytes, program layer): bytes a call copied from the host
into the programs' inputs (the ``bytes`` attribute of each
``alac.program.fill`` span), from the port's spans in the traced window."""

from benchmark.port_spans import per_call


def read(ctx):
    return per_call(ctx, lambda spans: sum(s.attrs.get("bytes", 0) for s in spans
                                           if s.name == "alac.program.fill"))
