"""setup_s (s): process start to the first timed call: imports, loading
or building the kernel libraries, making the inputs and warming every shape
the window uses (host clock)."""


def read(ctx):
    return ctx.setup_s
