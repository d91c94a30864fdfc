"""Tight staging of the port's batch decoder (`TorchBatchDecoder(cfg,
"cpu", tight=True)`): the packets uploaded back to back, each padded only to
its own word, and the padded rows gathered on the device.  Mirrors
tests/test_tight.py: bytes equal to the port's padded path, to the JAX
package's `JaxBatchDecoder(cfg, tight=True)` (on the ragged batch: each
JAX config costs a compile) and to the JAX oracle, over a depth x channel
matrix, ragged sizes with a partial frame and a single packet; the gathered rows equal the padded rows word for word, so a row
reads zeros past its packet (a truncated packet followed by a full one
fails as it does padded); the 32-tap retry stages tight again."""

import dataclasses

import numpy as np
import pytest

from conftest import make_config, music_pcm

from saprobe_alac_tpu.codec import decode_packet as oracle
from saprobe_alac_tpu.encoder import ChannelSpec, EncoderSpec, encode_packets
from saprobe_alac_tpu.ops.batch import JaxBatchDecoder
from saprobe_alac_tpu_torch import PacketConfig, TorchBatchDecoder

F = 128


def _port(cfg):
    return PacketConfig(**dataclasses.asdict(cfg))


def _both(cfg, packets):
    """(tight bytes, padded bytes) of the port on the CPU device."""
    tight = TorchBatchDecoder(_port(cfg), "cpu", tight=True)
    padded = TorchBatchDecoder(_port(cfg), "cpu")
    got = tight.decode_packets(packets)
    assert tight.last_fallbacks == 0
    return got, padded.decode_packets(packets)


@pytest.mark.parametrize("depth,channels", [(16, 2), (24, 2), (16, 1), (20, 2), (32, 3)])
def test_tight_matches_padded_and_oracle(depth, channels):
    cfg = make_config(depth=depth, channels=channels, frame_length=F)
    pcm = music_pcm(3 * F - F // 3, channels, depth, seed=3)
    packets = encode_packets(cfg, EncoderSpec(), pcm)
    got, padded = _both(cfg, packets)
    assert got == padded == [oracle(cfg, p)[0] for p in packets]


def test_tight_ragged_sizes_and_partial_frame():
    """Music (small packets) and noise (escapes, large packets) mixed, and
    a short final frame: the padding the tight path removes."""
    cfg = make_config(depth=16, channels=2, frame_length=F)
    rng = np.random.default_rng(5)
    n = F * 12 - 100
    pcm = music_pcm(n, 2, 16, seed=8)
    noisy = rng.integers(-32768, 32768, pcm.shape).astype(np.int64)
    for i in np.flatnonzero(rng.random(12) < 0.5):
        pcm[i * F : (i + 1) * F] = noisy[i * F : (i + 1) * F]
    packets = encode_packets(cfg, EncoderSpec(), pcm)
    assert len({len(p) for p in packets}) > 3  # genuinely ragged
    got, padded = _both(cfg, packets)
    assert got == padded == [oracle(cfg, p)[0] for p in packets]
    assert got == JaxBatchDecoder(cfg, tight=True).decode_packets(packets)


def test_tight_single_packet():
    cfg = make_config(depth=16, channels=2, frame_length=F)
    pcm = music_pcm(F, 2, 16, seed=4)
    packets = encode_packets(cfg, EncoderSpec(), pcm)
    assert len(packets) == 1
    got, padded = _both(cfg, packets)
    assert got == padded == [oracle(cfg, packets[0])[0]]


def test_tight_rows_read_zeros_past_their_packet():
    """The gathered rows equal the padded rows, word for word: zero from
    ceil(size_bits / 32) on, never the next packet's words.  A truncated
    packet followed by a full one (whose words would follow it in the
    tight buffer) takes the device's error path and the host raises the
    oracle's class, as padded staging does."""
    cfg = make_config(depth=16, channels=2, frame_length=F)
    packets = encode_packets(cfg, EncoderSpec(), music_pcm(4 * F, 2, 16, seed=9))
    packets[1] = packets[1][: len(packets[1]) // 2 + 1]  # odd length: a partial word
    pcfg = _port(cfg)
    tight = TorchBatchDecoder(pcfg, "cpu", tight=True)
    padded = TorchBatchDecoder(pcfg, "cpu")
    wt, st = tight._stage(packets)
    wp, sp = padded._stage(packets)
    assert wt.shape == wp.shape and bool((wt == wp).all()) and bool((st == sp).all())
    flat, offsets, _, Wb = tight._host_stage(packets)
    assert flat.size >= int(offsets[len(packets) - 1]) + Wb  # the last row's slice fits
    err = tight.decode_async(packets)[1]
    assert int(err[1]) != 0 and bool((err[[0, 2, 3]] == 0).all())
    with pytest.raises(Exception) as want:
        oracle(cfg, packets[1])
    for dec in (tight, padded):
        with pytest.raises(Exception) as got:
            dec.decode_packets(packets)
        assert type(got.value).__name__ == type(want.value).__name__


def test_tight_32_tap_retry_stages_tight():
    """A batch with an order-12 lane runs again at 32 taps, staged tight."""
    cfg = make_config(depth=16, channels=1, frame_length=F)
    pcm = music_pcm(2 * F, 1, 16, seed=12)
    packets = encode_packets(cfg, EncoderSpec(channel=ChannelSpec(order=12)), pcm)
    tight = TorchBatchDecoder(_port(cfg), "cpu", tight=True)
    staged = []
    host_stage = tight._host_stage
    tight._host_stage = lambda *a: staged.append(host_stage(*a)) or staged[-1]
    assert tight.decode_packets(packets) == [oracle(cfg, p)[0] for p in packets]
    assert len(staged) == 2 and all(len(s) == 4 for s in staged)  # 9 taps, then 32
