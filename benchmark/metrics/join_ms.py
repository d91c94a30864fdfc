"""join_ms (ms, service layer): host ms a file in ``alac.service.join``
(the service's ``b"".join`` of a completed file's packets' PCM), its own
time over the files the traced window completed, from the port's spans."""

from benchmark.port_spans import own_ns, window_spans

JOIN = "alac.service.join"


def per_file_ms(ctx, name: str) -> float | None:
    """The own ms of the window's spans named ``name`` over its files
    completed (its ``alac.service.join`` spans); None without one."""
    spans = window_spans(ctx)
    files = sum(s.name == JOIN for s in spans) if spans else 0
    if not files:
        return None
    own = own_ns(spans)
    return sum(own[s.id] for s in spans if s.name == name) / 1e6 / files


def read(ctx):
    return per_file_ms(ctx, JOIN)
