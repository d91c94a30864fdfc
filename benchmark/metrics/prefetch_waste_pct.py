"""prefetch_waste_pct (%, facade layer): the share of the windows the
facade dispatched that were let go unread: the ``dropped`` attributes of
``alac.decoder.seek`` and ``alac.decoder.close`` over the ``windows``
attributes of ``alac.decoder.read``, from the port's spans in the traced
window; None without a dispatched window."""

from benchmark.port_spans import window_spans

DROPPING = ("alac.decoder.seek", "alac.decoder.close")


def read(ctx):
    spans = window_spans(ctx)
    if spans is None:
        return None
    windows = sum(s.attrs.get("windows", 0) for s in spans if s.name == "alac.decoder.read")
    if not windows:
        return None
    dropped = sum(s.attrs.get("dropped", 0) for s in spans if s.name in DROPPING)
    return 100.0 * dropped / windows
