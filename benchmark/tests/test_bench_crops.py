"""The training-data crop loader cell, `training_library_cd16.crops47s_t4`
(`loops/crops.py`): a sound run is correct on four threads, and the control
and three faults planted in the facade are not; the set-up's tail crops
reach every window size below the facade's window; the five readers of
the facade's spans, with two threads' spans interleaved.

A tiny library at F=64 on the CPU through the C++ core (``"native"``: the
facade's windows of 64, decoded on the host): three tracks of 0.6 s (414
packets), crops of 9,000 frames (141 packets: three windows and the one
dispatched after them), every crop's slices checked.  The control at the
cell's own size runs on a card."""

import functools
import time

import pytest

from benchmark import harness
from benchmark.tests.test_bench_metrics import ctx, metric, synthetic_trace
from benchmark.tests.test_bench_port_spans import recorded, sp  # noqa: F401

import saprobe_alac_tpu_torch as port

NAME = "training_library_cd16.crops47s_t4"
SEED = 2**33 + 29
NEW = ("open_ms", "packet_read_ms", "facade_ms", "prefetch_waste_pct", "lock_wait_ms")


def tiny():
    bench = harness.spec()
    work = harness.cell(bench, NAME)
    config = dict(harness.config_file(bench, work["config"]), frame_length=64, track_s=0.6)
    config["tiers"] = [dict(config["tiers"][0], tracks=3)]
    traffic = dict(harness.traffic_file(work["traffic"]), crop_samples=9000, check_mib=16)
    return bench, work, config, traffic


def crops_run(control=False, traced=False, seed=SEED):
    bench, work, config, traffic = tiny()
    return harness.run_cell(work, config, traffic, seed, 0.3, traced,
                            harness.metrics_for(bench, NAME, traced), time.perf_counter(),
                            device="native", control=control)


def test_the_cell_is_the_published_shape():
    """Four threads; crops of Stable Audio Open's 2,097,152 frames at 44.1
    kHz stereo, 16-bit, F 4096, from 12 tracks of 240 s."""
    bench = harness.spec()
    work = harness.cell(bench, NAME)
    full = harness.config_file(bench, work["config"])
    traffic = harness.traffic_file(work["traffic"])
    assert traffic["threads"] == 4 and traffic["crop_samples"] == 2_097_152
    (tier,) = full["tiers"]
    assert (tier["sample_rate"], tier["bit_depth"], tier["num_channels"], tier["tracks"]) == (
        44100, 16, 2, 12)
    assert (full["frame_length"], full["pb"], full["mb"], full["kb"], full["track_s"]) == (
        4096, 40, 10, 14, 240)
    assert work["chips"] == 1


def test_sound_run_is_correct():
    out = crops_run()
    assert out["correct"], out["checks"]
    notes = out["notes"]
    assert out["failed"] == 0 and out["attempted"] >= 4
    assert notes["crops_checked"] == notes["crops"] == out["attempted"]
    assert notes["crops_short"] == 0 and notes["fallback_packets"] == 0
    assert set(out["metrics"]) == {"decode_rate", "setup_s"}


def test_a_traced_run_reads_the_facades_metrics():
    out = crops_run(traced=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert all(got[n]["value"] > 0 for n in NEW if n != "lock_wait_ms"), got
    assert got["lock_wait_ms"]["value"] == 0.0  # the C++ core runs no program
    # A crop lets the window after its last one go with its decoder: one of
    # its four, none near a track's end.
    assert 0 < got["prefetch_waste_pct"]["value"] <= 25.0


def test_control_is_not_correct():
    out = crops_run(control=True)
    assert not out["correct"] and out["checks"]["bad_bytes"]["value"] > 0
    assert out["failed"] == 0


class Planted:
    """The port's decoder with a fault planted in what the loop sees."""

    last = None  # the previous crop's bytes, of any thread

    def __init__(self, dec, fault):
        self.dec, self.fault = dec, fault

    def seek_exact(self, t):
        if self.fault == "packet_start":  # the crop from its packet's first sample
            return self.dec.seek(t)
        return self.dec.seek_exact(t)

    def read(self, n):
        if self.fault == "window_left_out":
            window = 64 * 64 * 4  # 64 packets of F=64, 16-bit stereo
            got = self.dec.read(n + window)
            return got[:window] + got[2 * window :]
        got = self.dec.read(n)
        if self.fault == "previous_crop":
            got, Planted.last = Planted.last or got, got
        return got


@pytest.mark.parametrize("fault", ["packet_start", "window_left_out", "previous_crop"])
def test_fault_is_not_correct(fault, monkeypatch):
    real = port.new_decoder

    @functools.wraps(real)
    def planted(f, **kw):
        return Planted(real(f, **kw), fault)

    monkeypatch.setattr(port, "new_decoder", planted)
    monkeypatch.setattr(Planted, "last", None)
    out = crops_run()
    assert not out["correct"], out["checks"]


def test_tail_crops_reach_every_window_size():
    """The set-up's tail crops, run through the port: the facade dispatches
    a window of every size from 1 to 63 packets, and 64."""
    from benchmark.loops.crops import Load

    _, _, config, traffic = tiny()
    load = Load(port, config, traffic, SEED, "native")
    load.setup()
    sizes = set()
    real = port.BatchDecoder.decode_async

    def counting(self, packets):
        sizes.add(len(packets))
        return real(self, packets)

    try:
        port.BatchDecoder.decode_async = counting
        for t, s in load.tail_crops():
            load.run_crop(t, s)
    finally:
        port.BatchDecoder.decode_async = real
        load.release()
    assert sizes == set(range(1, 65))


def crop_tree(base, thread, at, skip_ms, read_ms, dropped):
    """One thread's crop at ``at`` ms: open 0-2, seek_exact 2-10 holding a
    packet read 2-3, a batch call 3-5 whose dispatch waits 3-4 for the
    program's lock, and the skip read 6-9 (2 windows) holding a packet read
    6-7; the read 10-(10 + read_ms) (3 windows) holding packet reads of 2
    and 1 ms; the decoder let go, ``dropped``, 1 ms."""
    end = at + 10 + read_ms
    spans = [sp(base + 1, "alac.decoder.open", at, at + 2, packets=2584),
             sp(base + 2, "alac.decoder.seek", at + 2, at + 10, exact=1, dropped=0),
             sp(base + 3, "alac.decoder.packets", at + 2, at + 3, base + 2, packets=64),
             sp(base + 4, "alac.batch.submit", at + 3, at + 5, base + 2),
             sp(base + 5, "alac.program.dispatch", at + 3, at + 5, base + 4),
             sp(base + 6, "alac.program.wait", at + 3, at + 3 + skip_ms, base + 5),
             sp(base + 7, "alac.decoder.read", at + 6, at + 9, base + 2, windows=2),
             sp(base + 8, "alac.decoder.packets", at + 6, at + 7, base + 7, packets=64),
             sp(base + 9, "alac.decoder.read", at + 10, end, windows=3),
             sp(base + 10, "alac.decoder.packets", at + 10, at + 12, base + 9),
             sp(base + 11, "alac.decoder.packets", at + 13, at + 14, base + 9),
             sp(base + 12, "alac.decoder.close", end, end + 1, dropped=dropped)]
    for s in spans:
        s.thread = thread
    return spans


def test_facade_readers_with_two_threads_interleaved(recorded):  # noqa: F811
    """Two threads' crops overlapping in time, their spans interleaved by
    start as the recorder returns them: each reader sums own times over
    both threads and divides by the crops (top-level opens)."""
    a = crop_tree(0, 1, 0, skip_ms=1, read_ms=20, dropped=1)
    b = crop_tree(100, 2, 1, skip_ms=0.5, read_ms=30, dropped=0)
    recorded += sorted(a + b, key=lambda s: s.start_ns)
    c = ctx(trace=synthetic_trace())
    assert metric("open_ms", c) == pytest.approx(2.0)
    assert metric("packet_read_ms", c) == pytest.approx((1 + 1 + 2 + 1) * 2 / 2)
    assert metric("lock_wait_ms", c) == pytest.approx((1 + 0.5) / 2)
    # Seek 8 less its packet read, batch call and skip read (1 + 2 + 3): 2;
    # the skip read 3 less its packet read: 2; the read less its packet
    # reads; the close 1.
    a_own = 2 + 2 + (20 - 3) + 1
    b_own = 2 + 2 + (30 - 3) + 1
    assert metric("facade_ms", c) == pytest.approx((a_own + b_own) / 2)
    assert metric("prefetch_waste_pct", c) == pytest.approx(100 * 1 / 10)
    # The batch readers count top-level submits: a facade's submits nest
    # in its reads and seeks, so they find no call.
    assert metric("pack_ms", c) is None and metric("dispatch_ms", c) is None
    # Card 0 idle 0-10, 30-50, 60-100; card 1 40-100: the threads' top-level
    # spans cover 0-42, so only 42-50 and 60-100 (card 0), 42-100 (card 1).
    assert metric("caller_idle_pct", c) == pytest.approx((48 + 58) / 2)


def test_facade_readers_read_none_without_the_facades_spans(recorded):  # noqa: F811
    """A port without the facade's spans (the parent), no spans in the
    window, or no trace: every new reader gives None."""
    c = ctx(trace=synthetic_trace())
    assert all(metric(n, c) is None for n in NEW)
    recorded += [sp(1, "alac.batch.submit", 0, 10), sp(2, "alac.batch.finish", 20, 30)]
    assert all(metric(n, c) is None for n in NEW)
    recorded += crop_tree(10, 1, 150, skip_ms=1, read_ms=5, dropped=1)  # past the window
    assert all(metric(n, c) is None for n in NEW)
    assert all(metric(n, ctx(trace=None)) is None for n in NEW)
    # Opens but no read: the waste reads None, the times read 0 or more.
    recorded[:] = [sp(1, "alac.decoder.open", 0, 1)]
    assert metric("prefetch_waste_pct", c) is None and metric("open_ms", c) == 1.0


CELL_SEEDS = [2**31 + 101, 2**31 + 202, 2**31 + 303]


@pytest.mark.chip
@pytest.mark.parametrize("seed", CELL_SEEDS)
def test_control_at_the_cells_own_size(seed, card, capsys):
    """The control, the reference one bit below the stated precision in the
    facade's place, at the cell's own size and load on the card: it has to
    come out as not correct."""
    bench = harness.spec()
    work = harness.cell(bench, NAME)
    config = harness.config_file(bench, work["config"])
    traffic = harness.traffic_file(work["traffic"])
    out = harness.run_cell(work, config, traffic, seed, bench["run_seconds"], False,
                           harness.metrics_for(bench, NAME, False), time.perf_counter(),
                           control=True)
    with capsys.disabled():
        print(f"control {NAME} seed {seed}: correct {out['correct']} checks {out['checks']} "
              f"notes {out['notes']}")
    assert not out["correct"] and out["checks"]["bad_bytes"]["value"] > 0


def test_sample_offsets_take_a_crops_first_and_last_frames():
    from benchmark.loads import rng
    from benchmark.loops.crops import Sample

    s = Sample(SEED, per_crop=8, crop=9000, frames=64, frame_bytes=4, mib=1)
    off = s.offsets(rng(SEED, 200))
    assert len(off) == 8 and off[0] == 0 and off[1] == 9000 - 64
    assert all(0 <= o <= 9000 - 64 for o in off)
    pcm = bytes(range(256)) * (9000 * 4 // 256 + 1)
    pcm = pcm[: 9000 * 4]
    s.offer(0, 5, pcm, off)
    assert s.kept[0][1] == 5
    assert bytes(s.buf[0, 1]) == pcm[-64 * 4 :] and bytes(s.buf[0, 0]) == pcm[: 64 * 4]
