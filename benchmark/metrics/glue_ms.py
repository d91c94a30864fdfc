"""glue_ms (ms, epilogue and glue layer): device ms per call in kernels
other than the three hand-written ones of the decode path (packet walk, LPC,
raw reader), by the profiler's kernel names; copies and memsets are not
kernels."""

from benchmark.readers import KERNELS, is_kernel_of


def read(ctx):
    if ctx.trace is None or not ctx.records:
        return None
    glue = sum(s for n, s in ctx.trace.op_seconds().items()
               if not n.startswith(("Memcpy", "Memset"))
               and not any(is_kernel_of(n, k) for k in KERNELS))
    return glue / len(ctx.records) * 1e3 if glue > 0 else None
