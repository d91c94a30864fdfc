"""open_ms (ms, container layer): host ms a crop in ``alac.decoder.open``
(the facade's demux of the file: the container sniffed, its sample table
and magic cookie read), its own time, from the port's spans in the traced
window.  A crop is a top-level ``alac.decoder.open``, of any thread: the
facade's other readers divide by the same count."""

from benchmark.port_spans import own_ns, window_spans

OPEN = "alac.decoder.open"


def per_crop_ms(ctx, *names: str) -> float | None:
    """The own ms of the window's spans named ``names``, summed over the
    threads, over its crops (its top-level ``alac.decoder.open`` spans);
    None without one."""
    spans = window_spans(ctx)
    crops = sum(s.name == OPEN and s.parent is None for s in spans) if spans else 0
    if not crops:
        return None
    own = own_ns(spans)
    return sum(own[s.id] for s in spans if s.name in names) / 1e6 / crops


def read(ctx):
    return per_crop_ms(ctx, OPEN)
