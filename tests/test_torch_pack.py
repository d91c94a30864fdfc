"""The padded staging of a batch (`TorchBatchDecoder._host_stage`): the
C++ packer that writes each packet, read in place, into a reused buffer
(`native.pack_rows`), and the decoder's pool of staging buffers, on the CPU.

`native.pack_packets` (a fresh zeroed array from a joined copy) is the
reference the packer is held against, word for word, into fresh, dirty and
reused buffers.  A call in flight holds a staging buffer of its own from
`decode_async` to `finish_async`; the counters ``staging_reuses`` and
``staging_allocs`` (`program.counts`) count the packs into a pooled buffer
and into a new one.
"""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import music_pcm

import saprobe_alac_tpu_torch as port
from saprobe_alac_tpu_torch import native
from saprobe_alac_tpu_torch.ops import batch, program
from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder
from saprobe_alac_tpu_torch.utils import profiling

#: Frame length: a plain CPU decode costs its rows, whatever the batch.
F = 64

#: (seed, packets, rows, longest packet in bytes): rows past the packets,
#: an empty batch, lengths not a multiple of 4, and several width buckets.
CASES = [(1, 7, 8, 64), (2, 33, 48, 401), (3, 0, 8, 0), (4, 128, 128, 4097), (5, 5, 16, 3),
         (6, 12, 12, 1023)]


def _random_packets(seed: int, count: int, longest: int) -> list[bytes]:
    """``count`` packets of random bytes, lengths 0..``longest`` with both
    ends present where the count allows."""
    g = np.random.default_rng(seed)
    lengths = g.integers(0, longest + 1, count)
    if count >= 2:
        lengths[:2] = (0, longest)
    return [g.integers(0, 256, int(k), dtype=np.uint8).tobytes() for k in lengths]


def _width(packets, extra: int = 0) -> int:
    longest = max((len(p) for p in packets), default=0)
    return batch._bucket((longest + 3) // 4 + native.GUARD_WORDS, floor=16) + extra


def _pack(packets, out):
    native.pack_rows(packets, native.packet_lengths(packets), out)
    return out


@pytest.mark.parametrize("extra", [0, 7])
@pytest.mark.parametrize("fill", ["empty", "ones", "reused"])
@pytest.mark.parametrize("case", CASES, ids=[f"seed{c[0]}" for c in CASES])
def test_pack_rows_equals_pack_packets(case, fill, extra):
    """Word for word `pack_packets`' rows, whatever the buffer held: fresh
    memory, every byte 0xFF, or a longer batch's rows packed first (every
    row full to its last word), so a stale word fails."""
    seed, count, rows, longest = case
    packets = _random_packets(seed, count, longest)
    width = _width(packets, extra)
    out = np.empty((rows, width), np.uint32)
    if fill == "ones":
        out.fill(0xFFFFFFFF)
    elif fill == "reused":
        full = 4 * (width - native.GUARD_WORDS)
        earlier = np.random.default_rng(seed).integers(1, 256, full, dtype=np.uint8).tobytes()
        _pack([earlier] * rows, out)
        assert (out[:, : width - native.GUARD_WORDS] != 0).all()
    want = native.pack_packets(packets, rows, width)
    assert np.array_equal(_pack(packets, out).view(np.int32), want)


@pytest.mark.parametrize("kind", ["memoryview", "bytearray", "mixed"])
def test_other_buffers_take_the_join(kind, monkeypatch):
    """Packets that are not all `bytes` are joined into one copy first
    (`native._flat`) and give the same words; `bytes` never are."""
    joined = []
    flat = native._flat
    monkeypatch.setattr(native, "_flat", lambda p: joined.append(len(p)) or flat(p))
    packets = _random_packets(7, 20, 301)
    rows, width = 24, _width(packets)
    want = _pack(packets, np.empty((rows, width), np.uint32))
    assert joined == []
    wrap = {"memoryview": memoryview, "bytearray": bytearray}
    other = [wrap.get(kind, memoryview if i % 2 else bytes)(p) for i, p in enumerate(packets)]
    got = _pack(other, np.full((rows, width), 0xFFFFFFFF, np.uint32))
    assert np.array_equal(got, want) and joined == [20]


@pytest.mark.parametrize("fault", ["narrow", "rows", "lengths", "strided", "dtype"])
def test_pack_rows_refuses_what_does_not_fit(fault):
    """A width that does not cover the longest packet and its guard words,
    more packets than rows, lengths that are not one a packet, and an
    output that is not C-contiguous 4-byte words raise before the core
    runs."""
    packets = _random_packets(8, 6, 120)
    lengths = native.packet_lengths(packets)
    width = (120 + 3) // 4 + native.GUARD_WORDS
    out = np.empty((8, width), np.uint32)
    if fault == "narrow":
        out = np.empty((8, width - 1), np.uint32)
    elif fault == "rows":
        out = np.empty((5, width), np.uint32)
    elif fault == "lengths":
        lengths = lengths[:-1]
    elif fault == "strided":
        out = np.empty((8, 2 * width), np.uint32)[:, ::2]
    else:
        out = np.empty((8, width), np.float64)
    with pytest.raises(ValueError):
        native.pack_rows(packets, lengths, out)


def _config(depth=16, channels=2):
    return port.PacketConfig(F, depth, channels, 40, 10, 14, 255, 0, 0, 44100)


def _packets(cfg, n, seed, order=4, tonality=0.98):
    pcm = music_pcm(n * F, cfg.num_channels, cfg.bit_depth, seed=seed, tonality=tonality)
    spec = port.EncoderSpec(channel=port.ChannelSpec(order=order))
    return port.encode_packets(cfg, spec, pcm, backend="native")


def _native(cfg, packets):
    return port.BatchDecoder(cfg, "native").decode_packets(packets)


def _staging_counts():
    c = program.counts("cpu")
    return c["staging_reuses"], c["staging_allocs"]


@pytest.fixture(autouse=True)
def _clean():
    program.clear()
    program.reset_counts()
    yield
    program.clear()


def test_two_calls_in_flight_hold_distinct_buffers():
    """Two calls submitted before either finishes each hold a staging
    buffer of their own; `finish_async` gives both back, and a third call
    packs into one of them."""
    cfg = _config()
    pk = _packets(cfg, 12, seed=1)
    a, b = pk[:5], pk[5:]
    dec = TorchBatchDecoder(cfg, "cpu")
    ha, hb = dec.decode_async(a), dec.decode_async(b)
    assert ha.staging is not None and hb.staging is not None
    assert ha.staging.data_ptr() != hb.staging.data_ptr() and dec._staging_free == []
    held = {ha.staging.data_ptr(), hb.staging.data_ptr()}
    assert dec.finish_async(hb, b) == _native(cfg, b)
    assert dec.finish_async(ha, a) == _native(cfg, a)
    assert ha.staging is None and hb.staging is None
    assert {t.data_ptr() for t in dec._staging_free} == held
    hc = dec.decode_async(a)
    assert hc.staging.data_ptr() in held and len(dec._staging_free) == 1
    assert dec.finish_async(hc, a) == _native(cfg, a)
    assert _staging_counts() == (1, 2)


def test_a_buffer_too_small_is_dropped():
    """A pooled buffer smaller than the call's rows is dropped and a larger
    one made; a later narrower call packs into the larger one."""
    cfg = _config(depth=24)
    pk = _packets(cfg, 10, seed=2)
    short = [p[:40] for p in pk[:3]]  # narrow rows: not decodable, only staged
    dec = TorchBatchDecoder(cfg, "cpu")
    small = dec._host_stage(short)[2]
    dec._give(dec._staging_free, small)
    assert dec.decode_packets(pk) == _native(cfg, pk)
    (big,) = dec._staging_free
    assert big.numel() > small.numel()
    assert dec._host_stage(short)[2] is big
    assert _staging_counts() == (1, 2)


def test_counters_and_the_pack_span():
    """A decoder's first padded pack makes a buffer, every later one on a
    free buffer reuses it; the ``alac.batch.pack`` span says which.  A
    dropped handle's buffer never comes back."""
    cfg = _config()
    pk = _packets(cfg, 6, seed=3)
    dec = TorchBatchDecoder(cfg, "cpu")
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            assert dec.decode_packets(pk) == _native(cfg, pk)
    packs = [s.attrs["reused"] for s in profiling.spans() if s.name == profiling.PACK]
    assert packs == [False, True, True] and _staging_counts() == (2, 1)
    h = dec.decode_async(pk)
    del h  # as the facade's seek drops its prefetch
    assert dec._staging_free == []
    dec.decode_packets(pk)
    assert _staging_counts() == (3, 2)


def test_a_handle_finished_twice_gives_its_buffer_back_once():
    cfg = _config()
    pk = _packets(cfg, 4, seed=4)
    dec = TorchBatchDecoder(cfg, "cpu")
    h = dec.decode_async(pk)
    assert dec.finish_async(h, pk) == dec.finish_async(h, pk) == _native(cfg, pk)
    assert len(dec._staging_free) == 1


def test_the_32_tap_retry_takes_a_buffer_of_its_own():
    """Order-12 packets run again at 32 taps: the retry's submit packs into
    a second buffer, and the finish gives both back."""
    cfg = _config()
    pk = _packets(cfg, 3, seed=5, order=12)
    dec = TorchBatchDecoder(cfg, "cpu")
    assert dec.decode_packets(pk) == _native(cfg, pk)
    assert program.counts("cpu")["wide_retries"] == 1
    assert len(dec._staging_free) == 2 and _staging_counts() == (0, 2)


@pytest.mark.parametrize("depth", [16, 24])
def test_a_short_batch_after_a_long_one(depth):
    """A call of a few short packets after one of many long ones, in as
    many rows, packs into the long call's buffer: every word of it is
    rewritten, and the bytes equal the native core's.  (At 24 bits the
    long packets' escapes and the short ones are of one width: one program
    key, so the short call's rows past its packets are the long call's.)"""
    cfg = _config(depth=depth)
    long_ = _packets(cfg, 16, seed=6 + depth, tonality=0.2)
    short = _packets(cfg, 3, seed=7 + depth)
    assert max(map(len, short)) <= min(map(len, long_))
    dec = TorchBatchDecoder(cfg, "cpu")
    for packets in (long_, long_, short, long_, short):
        assert dec.finish_async(dec.decode_async(packets, rows=16), packets) == _native(
            cfg, packets)
    assert _staging_counts() == (4, 1)


def test_threads_sharing_a_decoder_never_share_a_buffer():
    """Threads packing on one decoder, two stages held at a time each:
    no buffer is held twice at once, and each holds its own batch's words
    until it gives the buffer back."""
    cfg = _config()
    batches = [_random_packets(20 + k, 16 + k, 200 + 40 * k) for k in range(6)]
    wants = {k: native.pack_packets(b, 16 + k, _width(b)) for k, b in enumerate(batches)}
    dec = TorchBatchDecoder(cfg, "cpu")
    held, lock, faults = {}, threading.Lock(), []

    def work(k):
        for _ in range(40):
            stages = [dec._host_stage(batches[k], 16 + k) for _ in range(2)]
            with lock:
                for _, _, buf in stages:
                    held[buf.data_ptr()] = held.get(buf.data_ptr(), 0) + 1
                    faults.extend([k] if held[buf.data_ptr()] > 1 else [])
            for words, _, _ in stages:
                if not np.array_equal(words.numpy(), wants[k]):
                    faults.append(k)
            with lock:
                for _, _, buf in stages:
                    held[buf.data_ptr()] -= 1
            for _, _, buf in stages:
                dec._give(dec._staging_free, buf)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k % len(batches),)) for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and faults == []
    reuses, allocs = _staging_counts()
    assert reuses + allocs == 12 * 40 * 2 and len(dec._staging_free) <= 24


def test_staged_rows_on_the_device_equal_the_reference():
    """`_stage` (outside any program) uploads what `_host_stage` packed:
    `pack_packets`' words and the size_bits."""
    cfg = _config()
    pk = _packets(cfg, 9, seed=8)
    words, sizes = TorchBatchDecoder(cfg, "cpu")._stage(pk)
    rows = batch._bucket(len(pk))
    assert torch.equal(words, torch.from_numpy(native.pack_packets(pk, rows, _width(pk))))
    assert sizes.tolist() == [8 * len(p) for p in pk] + [0] * (rows - len(pk))
