"""kernels_per_call (count, program layer): device kernels, copies and
memsets in the traced window, per call."""


def read(ctx):
    if ctx.trace is None or not ctx.records:
        return None
    ops = ctx.trace.op_count()
    return ops / len(ctx.records) if ops else None
