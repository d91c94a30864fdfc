"""The port's span recorder (utils/profiling.py) and the counters of the
batch and program layers (ops/program.py `counts`), on the CPU.

Without a profiler a span records nothing and enters no `record_function`.
Under `torch.profiler.profile(activities=[CPU])` a batch call records the
tree ``alac.batch.submit`` (pack, program dispatch holding the wait for
the program's lock and the fill) and
``alac.batch.finish`` (download, the host fallback where there are error
lanes, trim), one ``call`` id a submit/finish pair, on the profiler's clock.
"""

import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import music_pcm

import saprobe_alac_tpu_torch as port
from saprobe_alac_tpu_torch.ops import program
from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder
from saprobe_alac_tpu_torch.utils import profiling

#: Frame length: a plain CPU decode costs its rows, whatever the batch.
F = 64
SUBMIT, FINISH = profiling.SUBMIT, profiling.FINISH
#: Every name the batch and program layers record: the module's constants.
NAMES = {SUBMIT, FINISH, profiling.FALLBACK, profiling.WAIT, *profiling.STAGES}


def _config(depth=16, channels=2):
    return port.PacketConfig(F, depth, channels, 40, 10, 14, 255, 0, 0, 44100)


def _packets(cfg, n, seed, order=4):
    pcm = music_pcm(n * F, cfg.num_channels, cfg.bit_depth, seed=seed)
    spec = port.EncoderSpec(channel=port.ChannelSpec(order=order))
    return port.encode_packets(cfg, spec, pcm, backend="native")


def _recorded(fn):
    """What ``fn`` returns (or the exception it raises) and the spans it
    recorded under a CPU-activity profiler."""
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        try:
            got = fn()
        except port.AlacError as exc:
            got = exc
    return got, profiling.spans()


def _tree(recorded):
    """(parent name, name) of each span, in the order they started."""
    by_id = {s.id: s for s in recorded}
    return [(by_id[s.parent].name if s.parent else None, s.name) for s in recorded]


def _check_nesting(recorded):
    """Each span lies inside its parent, shares its parent's call, and each
    top-level span of a call is a submit or a finish."""
    by_id = {s.id: s for s in recorded}
    for s in recorded:
        assert s.start_ns <= s.end_ns and s.name in NAMES
        if s.parent is None:
            assert s.name in (SUBMIT, FINISH)
            continue
        up = by_id[s.parent]
        assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns and up.call == s.call


@pytest.fixture(autouse=True)
def _clean():
    program.clear()
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def test_without_a_profiler_nothing_is_recorded(monkeypatch):
    """No profiler: no span is kept and `record_function` is never entered;
    the handle carries no call id and the counters still count."""
    entered = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: entered.append(name))
    cfg = _config()
    pk = _packets(cfg, 5, seed=1)
    dec = TorchBatchDecoder(cfg, "cpu")
    program.reset_counts()
    handle = dec.decode_async(pk)
    assert isinstance(handle, tuple) and handle.call is None
    assert dec.finish_async(handle, pk) == TorchBatchDecoder(cfg, "cpu").decode_packets(pk)
    with profiling.span("alac.test", k=1) as s:
        s.set(more=2)
    assert s.call is None and s is profiling.span("alac.other")
    assert profiling.spans() == [] and entered == []
    c = program.counts("cpu")
    assert (c["calls"], c["packets"]) == (2, 10)


_PADDED = [(None, SUBMIT), (SUBMIT, "alac.batch.pack"), (SUBMIT, "alac.program.dispatch"),
           ("alac.program.dispatch", "alac.program.wait"),
           ("alac.program.dispatch", "alac.program.fill"), (None, FINISH),
           (FINISH, "alac.batch.download"), (FINISH, "alac.batch.trim")]


@pytest.mark.parametrize("channels", [2, 8])
def test_a_call_records_its_tree(channels):
    """Stereo and 7.1 (five elements a packet): one submit and one finish
    of one call id, the pack, the program's dispatch holding the wait for
    its lock and its fill, the download and the trim; one span a stage,
    never one a packet or an element."""
    cfg = _config(channels=channels)
    pk = _packets(cfg, 5, seed=2)
    dec = TorchBatchDecoder(cfg, "cpu")
    want = dec.decode_packets(pk)
    out, rec = _recorded(lambda: dec.decode_packets(pk))
    assert out == want
    assert _tree(rec) == _PADDED
    _check_nesting(rec)
    assert len({s.call for s in rec}) == 1
    submit = rec[0]
    assert submit.attrs == {"packets": 5, "card": "cpu", "taps": 9, "rows": 8,
                            "width": submit.attrs["width"]}
    dispatch = next(s for s in rec if s.name == "alac.program.dispatch")
    assert dispatch.attrs == {"kind": "decode", "ran": ("eager",)}


def test_submit_and_finish_pair_across_calls_in_flight():
    """Two calls in flight: each finish carries its own submit's call id,
    through the handle."""
    cfg = _config()
    a, b = _packets(cfg, 3, seed=3), _packets(cfg, 4, seed=4)
    dec = TorchBatchDecoder(cfg, "cpu")

    def two():
        ha, hb = dec.decode_async(a), dec.decode_async(b)
        return dec.finish_async(hb, b), dec.finish_async(ha, a), ha, hb

    (_, _, ha, hb), rec = _recorded(two)
    tops = [(s.name, s.call) for s in rec if s.parent is None]
    assert tops == [(SUBMIT, ha.call), (SUBMIT, hb.call), (FINISH, hb.call), (FINISH, ha.call)]
    assert ha.call != hb.call and isinstance(ha, tuple) and len(ha) == 4


def test_sharded_call_nests_each_shards_spans():
    """A ``["cpu", "cpu"]`` ShardedBatchDecoder: one submit/finish pair a
    call, each shard's own submit and finish inside it with its card."""
    cfg = _config()
    pk = _packets(cfg, 7, seed=5)
    dec = port.ShardedBatchDecoder(cfg, ["cpu", "cpu"])
    want = dec.decode_packets(pk)
    out, rec = _recorded(lambda: dec.decode_packets(pk))
    assert out == want
    _check_nesting(rec)
    assert [s.name for s in rec if s.parent is None] == [SUBMIT, FINISH]
    assert len({s.call for s in rec}) == 1
    top = {s.id for s in rec if s.parent is None}
    shards = [s for s in rec if s.parent in top]
    assert [s.name for s in shards] == [SUBMIT, SUBMIT, FINISH, FINISH]
    assert all(s.attrs["card"] == "cpu" for s in shards)
    assert rec[0].attrs == {"packets": 7, "shards": 2}
    assert sum(s.name == "alac.batch.trim" for s in rec) == 2


def test_a_wide_batch_retries_inside_its_finish():
    """Order-12 packets take the 32-tap retry: its submit (pack, dispatch,
    wait, fill) nests in the finish's download, in the same call, and
    ``wide_retries`` counts it."""
    cfg = _config(channels=1)
    pk = _packets(cfg, 3, seed=6, order=12)
    dec = TorchBatchDecoder(cfg, "cpu")
    want = dec.decode_packets(pk)
    program.reset_counts()
    out, rec = _recorded(lambda: dec.decode_packets(pk))
    assert out == want
    _check_nesting(rec)
    assert len({s.call for s in rec}) == 1
    assert _tree(rec) == _PADDED[:6] + [(FINISH, "alac.batch.download"),
                                        ("alac.batch.download", SUBMIT)] + [
        (SUBMIT, "alac.batch.pack"), (SUBMIT, "alac.program.dispatch"),
        ("alac.program.dispatch", "alac.program.wait"),
        ("alac.program.dispatch", "alac.program.fill"), (FINISH, "alac.batch.trim")]
    assert [s.attrs["taps"] for s in rec if s.name == SUBMIT] == [9, 32]
    c = program.counts("cpu")
    assert (c["calls"], c["packets"], c["wide_retries"], c["fallback_packets"]) == (1, 3, 1, 0)


def test_a_truncated_packet_records_its_fallback_before_the_oracle_raises():
    """A truncated packet: the finish holds an ``alac.batch.fallback`` span,
    recorded although the oracle's exception leaves it, and no trim;
    ``fallback_packets`` counts the packet."""
    cfg = _config()
    pk = _packets(cfg, 4, seed=7)
    bad = [pk[0], pk[1][:9], pk[2]]
    dec = port.BatchDecoder(cfg, "cpu")
    program.reset_counts()
    got, rec = _recorded(lambda: dec.decode_packets(bad))
    assert isinstance(got, port.BitstreamOverrun)
    _check_nesting(rec)
    assert _tree(rec)[-3:] == [(None, FINISH), (FINISH, "alac.batch.download"),
                               (FINISH, profiling.FALLBACK)]
    assert rec[-1].attrs == {"packets": 1}
    assert program.counts("cpu")["fallback_packets"] == 1


def test_fallback_counts_and_the_public_last_fallbacks():
    """A lane the device declines decodes on the host: the stage timer adds
    ``alac.batch.fallback``, ``fallback_packets`` counts it, and
    `BatchDecoder.last_fallbacks` says so without reaching into ``impl``."""
    cfg = _config()
    pk = _packets(cfg, 4, seed=8)
    dec = port.BatchDecoder(cfg, "cpu")
    dec.decode_packets(pk)
    assert dec.last_fallbacks == 0
    real = TorchBatchDecoder.finish_async

    def one_error_lane(self, handle, packets):  # lane 2 flagged by the walk
        packed, err, ns, wide = handle
        err = err.clone()
        err[2] = 1
        return real(self, (packed, err, ns, wide), packets)

    program.reset_counts()
    try:
        TorchBatchDecoder.finish_async = one_error_lane
        with profiling.stage_timer() as timer:
            out = dec.decode_packets(pk)
    finally:
        TorchBatchDecoder.finish_async = real
    assert out == port.BatchDecoder(cfg, "native").decode_packets(pk)
    assert dec.last_fallbacks == dec.impl.last_fallbacks == 1
    assert tuple(timer.phases) == profiling.STAGES + (profiling.FALLBACK,)
    assert timer.counts[profiling.FALLBACK] == 1
    assert program.counts("cpu")["fallback_packets"] == 1
    assert port.BatchDecoder(cfg, "native").last_fallbacks == 0


@pytest.mark.parametrize("depth", [16, 24])
def test_upload_bytes_are_the_payloads(depth):
    """``upload_bytes`` (counter and the fill span's ``bytes``) equals the
    bytes of the call's host stage, its words and size_bits, on a fill of
    the program's inputs."""
    cfg = _config(depth=depth)
    pk = _packets(cfg, 5, seed=9)
    dec = TorchBatchDecoder(cfg, "cpu")
    dec.decode_packets(pk)  # the key's first use: the caller's arrays as they are
    words, sizes, _ = dec._host_stage(pk)
    want = words.nbytes + sizes.nbytes
    program.reset_counts()
    _, rec = _recorded(lambda: dec.decode_packets(pk))
    (fill,) = [s for s in rec if s.name == "alac.program.fill"]
    assert fill.attrs["bytes"] == program.counts("cpu")["upload_bytes"] == want > 0


def test_span_times_are_the_profilers():
    """Over 50 spans, each recorded start and end lies within 100 us of the
    profiler's own event of that span (median)."""
    def spans():
        for k in range(50):
            with profiling.span("alac.test.clock", k=k):
                sum(range(2000))

    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans()
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "alac.test.clock"), key=lambda e: e.start_ns())
    rec = profiling.spans()
    assert len(events) == len(rec) == 50
    d_start = [abs(s.start_ns - e.start_ns()) for s, e in zip(rec, events)]
    d_end = [abs(s.end_ns - (e.start_ns() + e.duration_ns())) for s, e in zip(rec, events)]
    assert statistics.median(d_start) < 100_000 and statistics.median(d_end) < 100_000


def test_spans_off_build_no_attributes(monkeypatch):
    """No profiler: no site of the batch, program or sharded layers sets an
    attribute, so a span off builds nothing but its shared context."""
    built = []
    monkeypatch.setattr(profiling._Off, "set", lambda self, **attrs: built.append(attrs))
    cfg = _config()
    pk = _packets(cfg, 5, seed=10)
    TorchBatchDecoder(cfg, "cpu").decode_packets(pk)
    port.ShardedBatchDecoder(cfg, ["cpu", "cpu"]).decode_packets(pk)
    assert built == [] and profiling.spans() == []


def test_spans_select_by_interval_and_own_time():
    """`spans` keeps the spans that overlap the interval; `own_ns` takes
    each span's children off its duration."""
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("alac.test.outer") as outer:
            with profiling.span("alac.test.inner") as inner:
                sum(range(1000))
        with profiling.span("alac.test.later") as later:
            pass
    rec = profiling.spans()
    assert [s.name for s in rec] == ["alac.test.outer", "alac.test.inner", "alac.test.later"]
    assert profiling.spans(later.start_ns) == [later]
    assert profiling.spans(None, inner.end_ns) == [outer, inner]
    own = profiling.own_ns(rec)
    assert own[outer.id] == (outer.end_ns - outer.start_ns) - (inner.end_ns - inner.start_ns)
    assert own[inner.id] == inner.end_ns - inner.start_ns
    assert profiling._ring.maxlen == profiling.RING == 1 << 20


def test_trim_counts_the_device_decoded_bytes_and_records_its_threads():
    """A lane the device declines: ``trim_bytes`` advances by the bytes of
    the other lanes alone, and the recorded trim span carries the packets
    and bytes it copied and the threads that copied them."""
    cfg = _config()
    pk = _packets(cfg, 4, seed=11)
    dec = TorchBatchDecoder(cfg, "cpu")
    want = dec.decode_packets(pk)
    real = TorchBatchDecoder.finish_async

    def one_error_lane(self, handle, packets):  # lane 1 flagged by the walk
        packed, err, ns, wide = handle
        err = err.clone()
        err[1] = 1
        return real(self, (packed, err, ns, wide), packets)

    program.reset_counts()
    try:
        TorchBatchDecoder.finish_async = one_error_lane
        out, rec = _recorded(lambda: dec.decode_packets(pk))
    finally:
        TorchBatchDecoder.finish_async = real
    assert out == want
    copied = sum(len(b) for i, b in enumerate(out) if i != 1)
    (trim,) = [s for s in rec if s.name == "alac.batch.trim"]
    assert trim.attrs == {"packets": 3, "bytes": copied, "threads": 1}
    c = program.counts("cpu")
    assert c["trim_bytes"] == copied > 0 and c["fallback_packets"] == 1
