"""submit_ms (ms, batch layer): host ms a call inside
`BatchDecoder.decode_async` (pack, bucket, program fill, replay enqueue),
the mean over the traced window's calls."""

from benchmark.readers import per_call


def read(ctx):
    return per_call(ctx, "submit_ms")
