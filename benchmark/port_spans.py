"""The port's own spans inside a traced window, for the readers of the
batch and program layers' metrics.

While a torch.profiler session records, the port records spans named
``alac.<layer>.<stage>`` (`saprobe_alac_tpu_torch.utils.profiling.spans`:
each with ``name``, ``start_ns`` and ``end_ns`` on the profiler's clock,
``id``, ``parent`` (None at the top) and ``attrs``).  A reader takes the spans that lie inside the
window, [``trace.start_ns``, ``trace.end_ns``]; where the port has no
recorder, or the window holds none of its spans, it gives None.  A call is
a top-level ``alac.batch.submit`` span: "per call" divides by their number.
"""

from __future__ import annotations

import importlib

PROFILING = "saprobe_alac_tpu_torch.utils.profiling"
PREFIX = "alac."
SUBMIT = "alac.batch.submit"


def window_spans(ctx) -> list | None:
    """The port's spans inside the traced window, by start; None without
    a trace, a recorder or a span."""
    if ctx.trace is None:
        return None
    try:
        profiling = importlib.import_module(PROFILING)
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    t = ctx.trace
    inside = [s for s in read(t.start_ns, t.end_ns) if s.name.startswith(PREFIX)
              and t.start_ns <= s.start_ns and s.end_ns <= t.end_ns]
    return inside or None


def own_ns(spans) -> dict:
    """Each span's own nanoseconds: its duration less its children's.  The
    port has the same arithmetic (`profiling.own_ns`); the benchmark keeps
    its own, so that a change to the program cannot change how a metric is
    computed from the spans."""
    own = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


def per_call(ctx, total) -> float | None:
    """``total(spans)`` over the window's spans, divided by its calls."""
    spans = window_spans(ctx)
    if spans is None:
        return None
    calls = sum(s.name == SUBMIT and s.parent is None for s in spans)
    return total(spans) / calls if calls else None


def stage_ms(ctx, name: str) -> float | None:
    """Milliseconds a call of the spans named ``name``, each its own time
    (what its child spans cover is theirs)."""
    def total(spans):
        own = own_ns(spans)
        return sum(own[s.id] for s in spans if s.name == name) / 1e6

    return per_call(ctx, total)


def _merged(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _covered(gaps, intervals) -> int:
    """Nanoseconds of the sorted, disjoint ``gaps`` that the sorted,
    disjoint ``intervals`` cover."""
    covered, j = 0, 0
    for s, e in gaps:
        while j < len(intervals) and intervals[j][1] <= s:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < e:
            covered += min(e, intervals[k][1]) - max(s, intervals[k][0])
            k += 1
    return covered


def caller_idle_pct(ctx) -> float | None:
    """The share of the window in which a card is idle while the host is
    inside no top-level port span, averaged over the cards."""
    spans = window_spans(ctx)
    t = ctx.trace
    if spans is None or not t.devices or t.end_ns <= t.start_ns:
        return None
    inside = _merged((s.start_ns, s.end_ns) for s in spans if s.parent is None)
    idle = 0
    for d in t.devices:
        gaps = t.gaps(d)
        idle += sum(e - s for s, e in gaps) - _covered(gaps, inside)
    return 100.0 * idle / len(t.devices) / (t.end_ns - t.start_ns)
