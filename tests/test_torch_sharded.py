"""The port's packet-axis `ShardedBatchDecoder` on several ``"cpu"``
devices (each shard runs the single-device pipeline, the kernels' plain
versions).  Mirrors tests/test_sharded.py: 8, 4 and 3 devices, an uneven
batch and a single packet, the config matrix, an error lane and a declined
lane (the host fallback, summed over shards), and F=4096; bytes equal to
the JAX oracle, and on the 8-device case to the JAX package's
`ShardedBatchDecoder` on conftest's 8-device CPU mesh (a JAX decoder
compiles for each config: once is enough).  Each shard's staging pool
serves the sharded calls as it serves its own: a buffer a call in flight,
given back once by its finish, never by a dropped handle.
`BatchDecoder(cfg)` shards exactly when there is more than one card."""

import dataclasses

import jax
import pytest
import torch

import test_golden as golden
from conftest import make_config, music_pcm

from saprobe_alac_tpu.codec import decode_packet as oracle
from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
from saprobe_alac_tpu.parallel import ShardedBatchDecoder as JaxShardedBatchDecoder
from saprobe_alac_tpu.parallel import make_packet_mesh as jax_mesh
import saprobe_alac_tpu_torch as port
from saprobe_alac_tpu_torch.ops import program
from saprobe_alac_tpu_torch.parallel import ShardedBatchDecoder, make_packet_mesh


#: Frame length of the cases without a JAX decoder: a plain CPU decode costs
#: its rows, whatever B is.
F = 64


def _port(cfg):
    return port.PacketConfig(**dataclasses.asdict(cfg))


def _decode(cfg, packets, n):
    dec = ShardedBatchDecoder(_port(cfg), ["cpu"] * n)
    out = dec.decode_packets(packets)
    return out, dec


def test_sharded_8_devices_matches_jax_and_oracle():
    cfg = make_config(frame_length=128)
    pkts = encode_packets(cfg, EncoderSpec(), music_pcm(128 * 12 - 9, 2, 16, seed=17))
    got, dec = _decode(cfg, pkts, 8)
    assert dec.last_fallbacks == 0 and len(dec.devices) == 8
    assert got == [oracle(cfg, p)[0] for p in pkts]
    assert got == JaxShardedBatchDecoder(cfg, mesh=jax_mesh(jax.devices())).decode_packets(pkts)


@pytest.mark.parametrize("n", [4, 3])
def test_sharded_subset_of_devices(n):
    """12 packets (a bucket of 12 rows) over 4 shards of 3 rows and over 3
    shards of 4."""
    cfg = make_config(frame_length=F)
    pkts = encode_packets(cfg, EncoderSpec(), music_pcm(F * 12, 2, 16, seed=18))
    got, _ = _decode(cfg, pkts, n)
    assert got == [oracle(cfg, p)[0] for p in pkts]


@pytest.mark.parametrize("extra", [1, 3])
def test_sharded_uneven_batch(extra):
    """B not a multiple of the shard count: padded lanes never leak."""
    n = 4
    cfg = make_config(frame_length=F)
    pkts = encode_packets(cfg, EncoderSpec(), music_pcm(F * (n + extra), 2, 16, seed=19 + extra))
    assert len(pkts) % n
    got, _ = _decode(cfg, pkts, n)
    assert got == [oracle(cfg, p)[0] for p in pkts]


def test_sharded_single_packet():
    """One packet over 8 devices: seven shards hold only padding."""
    cfg = make_config(frame_length=F)
    pkts = encode_packets(cfg, EncoderSpec(), music_pcm(F - 14, 2, 16, seed=23))
    assert len(pkts) == 1
    got, _ = _decode(cfg, pkts, 8)
    assert got == [oracle(cfg, pkts[0])[0]]


@pytest.mark.parametrize("depth,channels", [(24, 2), (16, 1), (32, 2)],
                         ids=["24bit-stereo", "16bit-mono", "32bit-stereo"])
def test_sharded_config_matrix(depth, channels):
    cfg = make_config(depth=depth, channels=channels, frame_length=F)
    pkts = encode_packets(cfg, EncoderSpec(bytes_shifted=depth // 24),
                          music_pcm(F * 10 - 5, channels, depth, seed=29 + depth))
    got, _ = _decode(cfg, pkts, 2)
    assert got == [oracle(cfg, p)[0] for p in pkts]


def test_sharded_32_tap_retry():
    """Order-12 packets in every shard: each shard runs again at 32 taps on
    its own device, with its own rows."""
    from saprobe_alac_tpu.encoder import ChannelSpec

    cfg = make_config(channels=1, frame_length=F)
    pkts = encode_packets(cfg, EncoderSpec(channel=ChannelSpec(order=12)),
                          music_pcm(F * 9, 1, 16, seed=43))
    dec = ShardedBatchDecoder(_port(cfg), ["cpu"] * 3)  # 12 rows: 4, 4 and 1 packets
    handle = dec.decode_async(pkts)
    assert all(bool(h[3].any()) for h, _ in handle)  # every shard flags a wide lane
    assert dec.finish_async(handle, pkts) == [oracle(cfg, p)[0] for p in pkts]
    assert dec.last_fallbacks == 0


def test_sharded_error_lane_and_declined_lane():
    """A truncated packet in the second shard raises the oracle's class; a
    lane the device declines (chan bits 33, golden vector 11) decodes on
    the host within its shard, counted in `last_fallbacks`; the clean
    batch decodes with none."""
    cfg = make_config(depth=32, channels=2, frame_length=F)
    pkts = encode_packets(cfg, EncoderSpec(bytes_shifted=1), music_pcm(F * 10, 2, 32, seed=31))
    dec = ShardedBatchDecoder(_port(cfg), ["cpu"] * 2)  # 12 rows: shards of 6
    bad = list(pkts)
    bad[9] = bad[9][:1]  # truncated mid-header, in the second shard
    with pytest.raises(Exception) as want:
        oracle(cfg, bad[9])
    with pytest.raises(port.DecodeError) as got:
        dec.decode_packets(bad)
    assert type(got.value).__name__ == type(want.value).__name__
    declined = list(pkts)
    declined[8] = golden.PKT_CPE_CHANBITS33
    assert dec.decode_packets(declined) == [oracle(cfg, p)[0] for p in declined]
    assert dec.last_fallbacks == 1
    assert dec.decode_packets(pkts) == [oracle(cfg, p)[0] for p in pkts]
    assert dec.last_fallbacks == 0


def test_sharded_f4096_production_frame():
    """F=4096 over two shards, one packet of 600 samples: the first shard
    decodes it in its four rows, the second holds padding only and is not
    dispatched.  (A plain F=4096 decode costs its rows: ~6 s for this
    packet on a CPU, ~16 s for a full one.)"""
    cfg = make_config(frame_length=4096)
    pkts = encode_packets(cfg, EncoderSpec(), music_pcm(600, 2, 16, seed=37))
    dec = ShardedBatchDecoder(_port(cfg), ["cpu"] * 2)
    handle = dec.decode_async(pkts)
    assert [len(part) for _, part in handle] == [1, 0] and handle[1][0] is None
    assert dec.finish_async(handle, pkts) == [oracle(cfg, pkts[0])[0]]


def test_batch_decoder_shards_exactly_with_several_cards(monkeypatch):
    """``BatchDecoder(cfg)`` (the card) builds a `ShardedBatchDecoder` over
    every card when there is more than one, and the single-device decoder
    on one card; `make_packet_mesh` names every card by default."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = port.PacketConfig(128, 16, 2, 40, 10, 14, 255, 0, 0, 44100)
    for count in (1, 2, 4):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        impl = port.BatchDecoder(cfg).impl
        assert isinstance(impl, ShardedBatchDecoder) == (count > 1)
        assert isinstance(impl, port.TorchBatchDecoder) == (count == 1)
        assert make_packet_mesh() == [torch.device("cuda", i) for i in range(count)]
        if count > 1:  # one single-device decoder a card, and no other
            assert impl.devices == make_packet_mesh()
            assert [shard.device for shard in impl._shards] == impl.devices
            assert all(type(shard) is port.TorchBatchDecoder for shard in impl._shards)
        else:
            assert impl.device.type == "cuda"
    assert type(port.BatchDecoder(cfg, "cpu").impl) is port.TorchBatchDecoder


def _pool_case(seed):
    """(a two-shard decoder on the CPU, 10 packets, {packet: the oracle's
    bytes}): a batch of 6 or more packets puts some in each shard."""
    cfg = make_config(frame_length=F)
    pkts = encode_packets(cfg, EncoderSpec(), music_pcm(F * 10, 2, 16, seed=seed))
    dec = ShardedBatchDecoder(_port(cfg), ["cpu"] * 2)
    return dec, pkts, {p: oracle(cfg, p)[0] for p in pkts}


def _held(handle):
    """The staging buffer each shard's handle holds (None: none)."""
    return [h.staging for h, _ in handle]


def test_sharded_calls_in_flight_hold_their_own_staging():
    """Two sharded calls in flight: on each shard, each call holds a staging
    buffer of its own; each finish gives its buffers back to their shards,
    and a third call packs into them."""
    dec, pkts, want = _pool_case(seed=47)
    a, b = pkts[:6], pkts[3:10]
    ha, hb = dec.decode_async(a), dec.decode_async(b)
    ptrs_a = [t.data_ptr() for t in _held(ha)]
    ptrs_b = [t.data_ptr() for t in _held(hb)]
    assert all(pa != pb for pa, pb in zip(ptrs_a, ptrs_b))
    assert [s._staging_free for s in dec._shards] == [[], []]
    assert dec.finish_async(hb, b) == [want[p] for p in b]
    assert _held(hb) == [None, None]
    assert [[t.data_ptr() for t in s._staging_free] for s in dec._shards] == [[p] for p in ptrs_b]
    assert dec.finish_async(ha, a) == [want[p] for p in a]
    assert [{t.data_ptr() for t in s._staging_free} for s in dec._shards] == [
        {pa, pb} for pa, pb in zip(ptrs_a, ptrs_b)]
    program.reset_counts()
    assert dec.decode_packets(a) == [want[p] for p in a]
    c = program.counts("cpu")
    assert (c["staging_reuses"], c["staging_allocs"]) == (2, 0)


def test_a_dropped_sharded_handle_gives_no_buffer_back():
    """A sharded handle dropped unfinished (as the facade's seek drops its
    prefetch) gives no shard its buffer back: the next call makes new ones."""
    dec, pkts, want = _pool_case(seed=48)
    assert dec.decode_packets(pkts) == [want[p] for p in pkts]
    assert [len(s._staging_free) for s in dec._shards] == [1, 1]
    h = dec.decode_async(pkts)
    assert [s._staging_free for s in dec._shards] == [[], []]
    del h
    assert [s._staging_free for s in dec._shards] == [[], []]
    program.reset_counts()
    assert dec.decode_packets(pkts) == [want[p] for p in pkts]
    c = program.counts("cpu")
    assert (c["staging_reuses"], c["staging_allocs"]) == (0, 2)
    assert [len(s._staging_free) for s in dec._shards] == [1, 1]


def test_a_sharded_handle_finished_twice_gives_each_buffer_back_once():
    dec, pkts, want = _pool_case(seed=49)
    h = dec.decode_async(pkts)
    assert dec.finish_async(h, pkts) == dec.finish_async(h, pkts) == [want[p] for p in pkts]
    assert [len(s._staging_free) for s in dec._shards] == [1, 1]
