"""The sharded decoder over four ``"cpu"`` shards (parallel/mesh.py), as
the four-card cell runs it: bytes joined in packet order with a trailing
empty shard, an error lane in one shard and a 32-tap retry in another; a
shard's exception reaching the caller with no pooled buffer given back
twice; and, under a profiler, one top-level submit and finish a call with
each shard's own submit and finish inside them, as the benchmark's span
readers (`benchmark/port_spans.py`, `metrics/shard_concurrency.py`) count
them."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from conftest import music_pcm

import saprobe_alac_tpu_torch as port
from saprobe_alac_tpu_torch.codec import decode_packet as oracle
from saprobe_alac_tpu_torch.ops import program
from saprobe_alac_tpu_torch.parallel import ShardedBatchDecoder
from saprobe_alac_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, port_spans  # noqa: E402

#: Frame length: a plain CPU decode costs its rows, whatever the batch.
F = 64


def _config(channels=2):
    return port.PacketConfig(F, 16, channels, 40, 10, 14, 255, 0, 0, 44100)


def _packets(cfg, n, seed, order=4):
    pcm = music_pcm(n * F, cfg.num_channels, 16, seed=seed)
    spec = port.EncoderSpec(channel=port.ChannelSpec(order=order))
    return port.encode_packets(cfg, spec, pcm, backend="native")


def _want(cfg, packets):
    return [oracle(cfg, p)[0] for p in packets]


@pytest.fixture(autouse=True)
def _clean():
    program.clear()
    program.reset_counts()
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.mark.parametrize("n, shards", [(13, [4, 4, 4, 1]), (9, [3, 3, 3, 0])],
                         ids=["uneven", "trailing-empty"])
def test_four_shards_join_in_packet_order(n, shards):
    """Four shards, the last of one packet or of none (not dispatched):
    bytes equal to one shard's and to the oracle's, through
    `decode_packets` and `decode_async`/`finish_async`."""
    cfg = _config()
    pk = _packets(cfg, n, seed=61 + n)
    dec = ShardedBatchDecoder(cfg, ["cpu"] * 4)
    want = _want(cfg, pk)
    assert dec.decode_packets(pk) == want
    handle = dec.decode_async(pk)
    assert [len(part) for _, part in handle] == shards
    assert all((h is None) == (k == 0) for (h, _), k in zip(handle, shards))
    assert dec.finish_async(handle, pk) == want
    assert ShardedBatchDecoder(cfg, ["cpu"]).decode_packets(pk) == want


def test_a_shard_with_an_error_lane_and_one_with_a_wide_retry(monkeypatch):
    """16 packets over four shards of 4: the third shard's lanes of order
    12 run again at 32 taps on that shard alone, and a lane the second
    shard's walk flags decodes on the host; `last_fallbacks` sums them."""
    cfg = _config(channels=1)
    narrow, wide = _packets(cfg, 16, seed=71), _packets(cfg, 16, seed=71, order=12)
    pk = narrow[:8] + wide[8:12] + narrow[12:]
    dec = ShardedBatchDecoder(cfg, ["cpu"] * 4)
    handle = dec.decode_async(pk)
    assert [bool(h[3].any()) for h, _ in handle] == [False, False, True, False]
    assert dec.finish_async(handle, pk) == _want(cfg, pk)
    assert program.counts("cpu")["wide_retries"] == 1

    second = dec._shards[1]
    real = second.finish_async

    def one_error_lane(handle, packets):  # the shard's lane 2 flagged by the walk
        packed, err, ns, wide = handle
        err = err.clone()
        err[2] = 1
        return real((packed, err, ns, wide), packets)

    monkeypatch.setattr(second, "finish_async", one_error_lane)
    assert dec.decode_packets(pk) == _want(cfg, pk)
    assert dec.last_fallbacks == 1 and program.counts("cpu")["fallback_packets"] == 1


def _free(dec):
    """Each shard's free staging buffers, checked distinct."""
    free = [list(s._staging_free) for s in dec._shards]
    ptrs = [t.data_ptr() for f in free for t in f]
    assert len(ptrs) == len(set(ptrs)), "a buffer went back twice"
    return free


def test_a_shards_exception_reaches_the_caller_and_the_next_call_decodes():
    """A truncated packet in the third shard raises the oracle's exception
    through `decode_packets` and `finish_async`; the shards before it give
    their buffers back, the shard after it drops its handle unfinished,
    none gives one back twice, and the next call decodes."""
    cfg = _config()
    pk = _packets(cfg, 16, seed=81)
    dec = ShardedBatchDecoder(cfg, ["cpu"] * 4)
    want = _want(cfg, pk)
    assert dec.decode_packets(pk) == want
    bad = list(pk)
    bad[9] = bad[9][:1]
    with pytest.raises(port.AlacError) as first:
        dec.decode_packets(bad)
    handle = dec.decode_async(bad)
    with pytest.raises(port.AlacError) as second:
        dec.finish_async(handle, bad)
    assert type(first.value) is type(second.value)
    assert [len(f) for f in _free(dec)] == [1, 1, 1, 0]
    assert dec.decode_packets(pk) == want
    assert [len(f) for f in _free(dec)] == [1, 1, 1, 1]


def _ctx():
    """What the benchmark's span readers read: a window around every span."""
    return SimpleNamespace(trace=SimpleNamespace(start_ns=0, end_ns=1 << 63, devices=[]))


@pytest.mark.parametrize("how", ["decode_packets", "async"])
def test_a_sharded_call_records_one_call_with_each_shards_spans(how):
    """Four shards under a profiler: one top-level submit and one top-level
    finish (`port_spans.per_call` counts one call), each holding the
    shards' own submit or finish (its card), their pack or trim inside;
    the concurrency reader reads them (the shards in turn: at most 1)."""
    cfg = _config()
    pk = _packets(cfg, 14, seed=85)
    dec = ShardedBatchDecoder(cfg, ["cpu"] * 4)
    want = dec.decode_packets(pk)

    def call():
        if how == "async":
            return dec.finish_async(dec.decode_async(pk), pk)
        return dec.decode_packets(pk)

    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = call()
    rec = profiling.spans()
    assert out == want
    tops = [s for s in rec if s.parent is None]
    assert [s.name for s in tops] == [profiling.SUBMIT, profiling.FINISH]
    assert all(s.call == tops[0].call for s in rec)
    assert port_spans.per_call(_ctx(), lambda spans: 1.0) == 1.0
    by_id = {s.id: s for s in rec}
    for top in tops:
        shards = [s for s in rec if s.parent == top.id]
        assert [s.name for s in shards] == [top.name] * 4
        assert all(s.attrs["card"] == "cpu" for s in shards)
        assert all(a.end_ns <= b.start_ns for a, b in zip(shards, shards[1:]))
    for s in rec:
        if s.name in (profiling.PACK, profiling.TRIM):
            assert by_id[by_id[s.parent].parent].parent is None
    ctx = _ctx()
    assert 0 < harness.module("metrics", "shard_concurrency").read(ctx) <= 1.0
    assert harness.module("metrics", "pack_ms").read(ctx) > 0
