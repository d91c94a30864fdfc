"""upload_ms (ms, program layer): host ms a call copying the host arrays
into the program's inputs (``alac.program.fill``: `Program._fill`, and the
staging of a key's first use), from the port's spans in the traced window."""

from benchmark.port_spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "alac.program.fill")
