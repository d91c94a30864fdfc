"""finish_ms (ms, batch layer): host ms a call inside
`BatchDecoder.finish_async` after a synchronise of every card (download,
trim, fallbacks), the mean over the traced window's calls."""

from benchmark.readers import per_call


def read(ctx):
    return per_call(ctx, "finish_ms")
