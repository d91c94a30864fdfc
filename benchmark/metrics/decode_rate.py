"""decode_rate (audio_s/s): seconds of audio decoded to PCM bytes over the
window's wall time, from its start to the last completion; every call that
returned all its packets counts (host clock)."""


def read(ctx):
    if not ctx.records or ctx.window_s <= 0:
        return None
    return sum(c["audio_s"] for c in ctx.records if c["done"]) / ctx.window_s
