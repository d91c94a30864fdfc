"""The four-card cell, `cd16_stereo.batch2048.x4`, and its two readers of
the parallel layer (`shard_concurrency`, `shard_skew_ms`): their
arithmetic on synthetic port spans and device traces; the cell's files, found by name as
any cell's; a tiny run of them on the CPU; and its sound, control and
fault runs on four cards (skipped below four)."""

import time
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.trace import DeviceOp, Trace
from benchmark.tests.test_bench_correct import altered_answer, half_the_batch, unchanged_state
from benchmark.tests.test_bench_metrics import ctx, metric, synthetic_trace

CELL = "cd16_stereo.batch2048.x4"
READERS = ("shard_concurrency", "shard_skew_ms")
MS = 1_000_000
#: The cell at a size the CPU runs in seconds (4 packets a card on four).
TINY = ({"frame_length": 256}, {"packets": 16, "check_packets": 4, "check_mib": 1})


SUBMIT, FINISH = "alac.batch.submit", "alac.batch.finish"


def sp(id_, name, start_ms, end_ms, parent=None, call=None, **attrs):
    return SimpleNamespace(id=id_, name=name, start_ns=int(start_ms * MS), end_ns=int(end_ms * MS),
                           parent=parent, call=call if call is not None else id_, attrs=attrs)


def sharded_call(base, at, submits, finishes):
    """A call at ``at`` ms: the caller's submit 0-10 and finish 20-60, and
    each shard's own submit and finish inside them at the (start, end)
    given, relative to ``at``."""
    call = base + 1
    spans = [sp(call, SUBMIT, at, at + 10), sp(base + 2, FINISH, at + 20, at + 60, call=call)]
    for k, (s, e) in enumerate(submits):
        spans.append(sp(base + 10 + k, SUBMIT, at + s, at + e, call, call, card=f"cuda:{k}"))
    for k, (s, e) in enumerate(finishes):
        spans.append(sp(base + 20 + k, FINISH, at + s, at + e, base + 2, call, card=f"cuda:{k}"))
    return spans


@pytest.fixture
def recorded(monkeypatch):
    from saprobe_alac_tpu_torch.utils import profiling

    spans = []
    monkeypatch.setattr(profiling, "spans", lambda start=None, end=None: [
        s for s in spans if (start is None or s.end_ns >= start) and (end is None or s.start_ns <= end)])
    return spans


def test_shards_one_after_another_read_one(recorded):
    """Four shards in turn inside each of the call's spans: concurrency 1."""
    recorded += sharded_call(0, 0, [(0, 2.5), (2.5, 5), (5, 7.5), (7.5, 10)],
                             [(20, 30), (30, 40), (40, 50), (50, 60)])
    assert metric("shard_concurrency", ctx(trace=synthetic_trace())) == pytest.approx(1.0)


def test_four_shards_side_by_side_read_four(recorded):
    recorded += sharded_call(0, 0, [(0, 10)] * 4, [(20, 60)] * 4)
    assert metric("shard_concurrency", ctx(trace=synthetic_trace())) == pytest.approx(4.0)


def test_concurrency_sums_the_shards_over_their_calls(recorded):
    """Two calls of two shards each; a one-card call beside them (a
    top-level submit and finish with nothing of the same name inside)
    counts in neither sum."""
    recorded += sharded_call(0, 0, [(0, 10), (0, 5)], [(20, 57), (20, 60)])
    recorded += sharded_call(100, 0, [(0, 10), (0, 10)], [(25, 60), (20, 55)])
    recorded += [sp(201, SUBMIT, 70, 80), sp(202, "alac.batch.pack", 71, 75, 201, 201),
                 sp(203, FINISH, 80, 90, call=201)]
    runs = (10 + 5 + 37 + 40) + (10 + 10 + 35 + 35)
    assert metric("shard_concurrency", ctx(trace=synthetic_trace())) == pytest.approx(
        runs / (2 * (10 + 40)))


def test_concurrency_reads_none_without_a_sharded_call(recorded):
    """The one-card layout (a pack inside the call's submit, no shard's own
    submit) or no trace: None."""
    recorded += [sp(1, SUBMIT, 0, 10), sp(2, "alac.batch.pack", 1, 5, 1, 1),
                 sp(3, FINISH, 30, 90, call=1)]
    assert metric("shard_concurrency", ctx(trace=synthetic_trace())) is None
    assert metric("shard_concurrency", ctx(trace=None)) is None


def cards_trace(calls, devices=(0, 1, 2, 3)):
    """A traced window on the cards ``devices``: each call ``(at, ends)`` a
    harness submit at ``at``-``at``+10 ms and a sync at +40-+50, and on
    each card of ``ends`` an upload at +1-+2, a kernel from +5 to the
    card's end and a download after the sync (+55-+58)."""
    ops, spans = [], [("bench.window", 0, 1000 * MS)]
    for at, ends in calls:
        spans += [("bench.submit", at * MS, (at + 10) * MS),
                  ("bench.sync", (at + 40) * MS, (at + 50) * MS),
                  ("bench.finish", (at + 50) * MS, (at + 60) * MS)]
        for d, end in zip(devices, ends):
            ops += [DeviceOp(d, "Memcpy HtoD", (at + 1) * MS, (at + 2) * MS),
                    DeviceOp(d, "packet_kernel", (at + 5) * MS, (at + end) * MS),
                    DeviceOp(d, "Memcpy DtoH", (at + 55) * MS, (at + 58) * MS)]
    return Trace(0, 1000 * MS, list(devices), ops, spans)


def test_skew_of_cards_dispatched_in_turn():
    """Four cards whose last operations end 3 ms apart: 9 ms; the download
    after the sync is not the call's device work."""
    t = cards_trace([(0, [10, 13, 16, 19])])
    assert metric("shard_skew_ms", ctx(trace=t)) == pytest.approx(9.0)


def test_skew_of_cards_that_finish_together_is_zero():
    assert metric("shard_skew_ms", ctx(trace=cards_trace([(0, [12] * 4)]))) == pytest.approx(0.0)


def test_skew_is_the_mean_over_calls_of_last_less_first_end():
    """Two calls, 9 ms and 5 ms; a third in which one card alone ran
    counts in neither."""
    t = cards_trace([(0, [10, 13, 16, 19]), (100, [20, 15, 18, 17]), (200, [30])])
    assert metric("shard_skew_ms", ctx(trace=t)) == pytest.approx((9 + 5) / 2)


def test_skew_reads_none_on_one_card_or_without_a_trace():
    assert metric("shard_skew_ms", ctx(trace=cards_trace([(0, [10])], devices=(0,)))) is None
    assert metric("shard_skew_ms", ctx(trace=None)) is None
    assert metric("shard_skew_ms", ctx(trace=cards_trace([(0, [10]), (100, [12])]))) is None


def test_the_cell_is_found_by_its_names():
    """Config `cd16_stereo_hgx4`, traffic `batch2048.x4` of the batch loop:
    8,192 packets a call, four times `batch2048`'s, with its check; four
    chips; its per-layer metrics the batch, program, kernel and device
    readers and the two shard readers."""
    bench = harness.spec()
    work = harness.cell(bench, CELL)
    assert (work["config"], work["traffic"], work["chips"]) == ("cd16_stereo_hgx4", "batch2048.x4",
                                                                4)
    x4, one = harness.traffic_file("batch2048.x4"), harness.traffic_file("batch2048")
    assert x4["kind"] == one["kind"] == "batch" and x4["packets"] == 4 * one["packets"] == 8192
    assert (x4["check_packets"], x4["check_mib"]) == (one["check_packets"], one["check_mib"])
    traced = {m["name"] for m in harness.metrics_for(bench, CELL, True)}
    assert traced == {"submit_ms", "finish_ms", "kernels_per_call", "glue_ms", "walk_roofline",
                      "lpc_roofline", "device_idle_pct", "caller_idle_pct", "pack_ms",
                      "upload_ms", "dispatch_ms", "download_ms", "trim_ms", "upload_bytes",
                      *READERS}
    assert {m["name"] for m in harness.metrics_for(bench, CELL, False)} == {"decode_rate",
                                                                            "setup_s"}
    for name in READERS:
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert (m["layer"], m["moves"], m["workloads"]) == ("parallel", "decode_rate", [CELL])


def test_the_hosts_configuration_decodes_cd16_stereos_packets():
    """The four-card host is a deployment of its own (its source and its
    ``host`` group), but its packets are `cd16_stereo`'s: every number the
    input maker and the decoder read is the same, so x4 over the one-card
    cell is the host's scaling."""
    bench = harness.spec()
    host = harness.config_file(bench, "cd16_stereo_hgx4")
    one = harness.config_file(bench, "cd16_stereo")
    (entry,) = [c for c in bench["configs"] if c["name"] == "cd16_stereo_hgx4"]
    (base,) = [c for c in bench["configs"] if c["name"] == "cd16_stereo"]
    assert entry["source"] == host["source"] != base["source"] and entry["reduced"] == []
    assert host["host"]["cards"] == harness.cell(bench, CELL)["chips"] == 4
    shared = set(one) - {"name", "deployment", "source", "assumed"}
    assert {k: host[k] for k in shared} == {k: one[k] for k in shared}
    assert set(host) - set(one) == {"host"}


def tiny_run(seed=2**31 + 17, traced=False, control=False, seconds=0.2, device="cpu"):
    bench = harness.spec()
    work = harness.cell(bench, CELL)
    config = dict(harness.config_file(bench, work["config"]), **TINY[0])
    traffic = dict(harness.traffic_file(work["traffic"]), **TINY[1])
    return harness.run_cell(work, config, traffic, seed, seconds, traced,
                            harness.metrics_for(bench, CELL, traced), time.perf_counter(),
                            device=device, control=control)


@pytest.mark.parametrize("traced", [False, True])
def test_the_cells_files_run_on_the_cpu(traced):
    """The cell's files through the harness, as a cell added as files
    only: correct, and its metrics read (one CPU decoder makes no sharded
    call and no card's trace, so the shard readers give nothing)."""
    out = tiny_run(traced=traced)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    if traced:
        assert {"pack_ms", "trim_ms", "upload_bytes"} <= set(out["metrics"])
        assert not set(READERS) & set(out["metrics"])
    else:
        assert set(out["metrics"]) == {"decode_rate", "setup_s"}


@pytest.fixture
def four_cards(card):
    if card < 4:
        pytest.skip("needs 4 cards")
    return card


@pytest.mark.chip
def test_sound_run_on_four_cards(four_cards):
    """Sharded over every card: correct, and traced the shard readers read."""
    out = tiny_run(device="cuda")
    assert out["correct"] and out["failed"] == 0, out["checks"]
    traced = tiny_run(device="cuda", traced=True)
    assert traced["correct"], traced["checks"]
    assert set(READERS) <= set(traced["metrics"])


@pytest.mark.chip
def test_control_on_four_cards(four_cards):
    out = tiny_run(device="cuda", control=True)
    assert not out["correct"] and out["checks"]["bad_bytes"]["value"] > 0


@pytest.mark.chip
@pytest.mark.parametrize("fault", [altered_answer, half_the_batch, unchanged_state])
def test_fault_on_four_cards(fault, four_cards, monkeypatch):
    fault(monkeypatch)
    out = tiny_run(device="cuda", seconds=0.5)
    assert not out["correct"], out["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("seed", [2**31 + 401, 2**31 + 402, 2**31 + 403])
def test_control_at_the_cells_own_size(seed, four_cards, capsys):
    """The control at the cell's own size and load on four cards: it has to
    come out as not correct."""
    bench = harness.spec()
    work = harness.cell(bench, CELL)
    config = harness.config_file(bench, work["config"])
    traffic = harness.traffic_file(work["traffic"])
    out = harness.run_cell(work, config, traffic, seed, bench["run_seconds"], False,
                           harness.metrics_for(bench, CELL, False), time.perf_counter(),
                           control=True)
    with capsys.disabled():
        print(f"control {CELL} seed {seed}: correct {out['correct']} checks {out['checks']} "
              f"notes {out['notes']}")
    assert not out["correct"]
