"""The readers of the port's spans (`port_spans.py` and its seven metrics)
on a synthetic trace with synthetic port spans, in place of what
`saprobe_alac_tpu_torch.utils.profiling.spans` records in a traced run."""

from types import SimpleNamespace

import pytest

from benchmark import port_spans
from benchmark.tests.test_bench_metrics import ctx, metric, synthetic_trace
from benchmark.trace import Trace

MS = 1_000_000
NAMES = ("pack_ms", "upload_ms", "dispatch_ms", "download_ms", "trim_ms", "upload_bytes",
         "caller_idle_pct")


def sp(id_, name, start_ms, end_ms, parent=None, **attrs):
    return SimpleNamespace(id=id_, name=name, start_ns=int(start_ms * MS),
                           end_ns=int(end_ms * MS), parent=parent, attrs=attrs)


def one_call(base, at):
    """A call at ``at`` ms: submit 0-10 (pack 0-4, dispatch 4-9 holding a
    fill 5-7 of 1000 bytes), finish 30-100 (download 30-40, trim 40-99)."""
    return [sp(base + 1, "alac.batch.submit", at, at + 10),
            sp(base + 2, "alac.batch.pack", at, at + 4, base + 1),
            sp(base + 3, "alac.program.dispatch", at + 4, at + 9, base + 1),
            sp(base + 4, "alac.program.fill", at + 5, at + 7, base + 3, bytes=1000),
            sp(base + 5, "alac.batch.finish", at + 30, at + 100),
            sp(base + 6, "alac.batch.download", at + 30, at + 40, base + 5),
            sp(base + 7, "alac.batch.trim", at + 40, at + 99, base + 5)]


@pytest.fixture
def recorded(monkeypatch):
    """Put ``spans`` in place of the port's recorder; returns the list to
    fill."""
    from saprobe_alac_tpu_torch.utils import profiling

    spans = []
    monkeypatch.setattr(profiling, "spans", lambda start=None, end=None: [
        s for s in spans if (start is None or s.end_ns >= start) and (end is None or s.start_ns <= end)])
    return spans


def test_stage_metrics_per_call(recorded):
    """Each stage's own ms and the fill's bytes, per top-level submit; a
    span past the window is not read."""
    recorded += one_call(0, 0) + [sp(99, "alac.batch.submit", 150, 160)]
    t = synthetic_trace()
    got = {n: metric(n, ctx(trace=t)) for n in NAMES}
    assert got["pack_ms"] == pytest.approx(4.0)
    assert got["upload_ms"] == pytest.approx(2.0)
    assert got["dispatch_ms"] == pytest.approx(3.0)  # 5 ms less the fill's 2
    assert got["download_ms"] == pytest.approx(10.0)
    assert got["trim_ms"] == pytest.approx(59.0)
    assert got["upload_bytes"] == 1000
    # Card 0 idle 0-10, 30-50, 60-100; card 1 idle 40-100.  The host is in a
    # port span 0-10 and 30-100: only the gaps' parts outside them count,
    # none here.
    assert got["caller_idle_pct"] == pytest.approx(0.0)


def test_caller_idle_on_the_synthetic_layout(recorded):
    """The synthetic trace's idle gaps less the port's top-level spans:
    with a submit 0-6 and a finish 50-80, card 0 is idle outside them 6-10,
    30-50 and 80-100 (44 ms), card 1 40-50 and 80-100 (30 ms)."""
    recorded += [sp(1, "alac.batch.submit", 0, 6), sp(2, "alac.batch.pack", 1, 5, 1),
                 sp(3, "alac.batch.finish", 50, 80)]
    c = ctx(trace=synthetic_trace())
    assert metric("caller_idle_pct", c) == pytest.approx((44 + 30) / 2)
    assert metric("pack_ms", c) == pytest.approx(4.0)


def test_two_calls_and_a_nested_retry(recorded):
    """Two calls: per-call means; a retry's submit inside a download is
    the download's child, so its time counts to its own stages alone."""
    recorded += one_call(0, 0)
    retry = [sp(20, "alac.batch.submit", 33, 38, 6), sp(21, "alac.batch.pack", 33, 35, 20)]
    recorded += retry
    recorded += one_call(100, 200)
    t = Trace(0, 400 * MS, [0], [], [])
    c = ctx(trace=t)
    assert metric("download_ms", c) == pytest.approx((5.0 + 10.0) / 2)
    assert metric("pack_ms", c) == pytest.approx((4 + 2 + 4) / 2)
    assert metric("caller_idle_pct", c) == pytest.approx(100 * (400 - 2 * 80) / 400)


def test_no_spans_read_none(recorded):
    """No span in the window, no trace, or a port without the recorder:
    every reader gives None."""
    for n in NAMES:
        assert metric(n, ctx(trace=synthetic_trace())) is None
        assert metric(n, ctx(trace=None)) is None
    recorded += [sp(1, "alac.batch.submit", 150, 160)]  # outside the window
    assert all(metric(n, ctx(trace=synthetic_trace())) is None for n in NAMES)


def test_a_port_without_the_recorder_reads_none(monkeypatch):
    from saprobe_alac_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert all(metric(n, ctx(trace=synthetic_trace())) is None for n in NAMES)


def test_covered_counts_the_overlap_of_sorted_intervals():
    gaps = [(0, 10), (20, 30), (40, 50)]
    assert port_spans._covered(gaps, [(5, 25), (45, 60)]) == 5 + 5 + 5
    assert port_spans._covered(gaps, []) == 0
    assert port_spans._merged([(5, 8), (0, 6), (10, 12)]) == [(0, 8), (10, 12)]
