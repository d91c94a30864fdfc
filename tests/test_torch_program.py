"""The port's decode programs (ops/program.py): one process-wide `Program`
per (config statics, rows, width, taps) key, its static inputs allocated
at its second call and filled anew by every call from then on.  On the
CPU every call runs the decode eagerly (from the second on those inputs),
so these tests reach the fill that a CUDA graph replay reads on the card:
calls of several sizes on one key, the 9- and 32-tap programs of one
batch, two calls in flight on one key (each at 16 bits and at 24 bits
bytesShifted=1, whose program also reads the shift region), and the
cache's budget (eviction by pool bytes, least recently used first).  Every
call's bytes equal the JAX package's `JaxBatchDecoder` and the JAX oracle,
packet by packet (one JAX call on all the packets: each packet decodes on
its own)."""

import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

from conftest import make_config, music_pcm

from saprobe_alac_tpu.codec import decode_packet as oracle
from saprobe_alac_tpu.encoder import ChannelSpec, EncoderSpec, encode_packets
from saprobe_alac_tpu.ops.batch import JaxBatchDecoder
from saprobe_alac_tpu_torch import PacketConfig, TorchBatchDecoder, _build
from saprobe_alac_tpu_torch.ops import program
from saprobe_alac_tpu_torch.ops.torchint import sext, shl, sshr, ushr

F = 128
ROWS = 48
#: Each depth's width bucket: every call below, at that depth, has it.
WIDTH = {16: 128, 24: 192}


@functools.cache
def _case(depth: int):
    """(port config, 48 stereo music packets of ``depth`` bits (the last
    partial; bytesShifted=1 at 24), an order-12 packet, {packet: the JAX
    decoder's bytes})."""
    cfg = make_config(depth=depth, channels=2, frame_length=F)
    bs = depth // 24
    pk = encode_packets(cfg, EncoderSpec(bytes_shifted=bs),
                        music_pcm(ROWS * F - 17, 2, depth, seed=5))
    o12 = encode_packets(cfg, EncoderSpec(channel=ChannelSpec(order=12), bytes_shifted=bs),
                         music_pcm(F, 2, depth, seed=6))[0]
    everything = pk + [o12]
    jax_out = JaxBatchDecoder(cfg).decode_packets(everything)
    want = {}
    for p, j in zip(everything, jax_out):
        assert j == oracle(cfg, p)[0]
        want[p] = j
    return PacketConfig(**dataclasses.asdict(cfg)), pk, o12, want


@pytest.fixture(scope="module")
def case():
    """`_case` at 16 bits."""
    return _case(16)


@pytest.fixture(autouse=True)
def fresh_cache():
    """Each test starts and ends with an empty process-wide cache."""
    program.clear()
    yield
    program.clear()


def _progs():
    """The cached programs on the CPU, least recently used first."""
    return program.programs("cpu")


def _decode(dec, packets, rows=ROWS):
    return dec.finish_async(dec.decode_async(packets, rows=rows), packets)


@pytest.mark.parametrize("depth", [16, 24])
def test_calls_of_several_sizes_share_a_program(depth):
    """Calls of 40, 33, 48 and 1 packets in one batch bucket, then 40 again
    (after the longer call of 48 on its key, so the staging buffer and the
    static inputs held that call's words past this call's packets): every
    call's bytes equal JAX's and the oracle's, through one program."""
    pc, pk, _, want = _case(depth)
    dec = TorchBatchDecoder(pc, "cpu")
    for n in (40, 33, 48, 1, 40):
        assert _decode(dec, pk[:n]) == [want[p] for p in pk[:n]]
        assert dec.last_fallbacks == 0
    (prog,) = _progs()
    assert prog.shape == (ROWS, WIDTH[depth], 9) and prog.uses == 5


@pytest.mark.parametrize("depth", [16, 24])
def test_wide_order_runs_the_32_tap_program_of_the_same_rows(depth):
    """A batch with one order-12 packet runs the 9-tap program, then the
    32-tap program of the same rows and width (finish_async's retry)."""
    pc, pk, o12, want = _case(depth)
    batch = pk[:20] + [o12] + pk[20:30]
    dec = TorchBatchDecoder(pc, "cpu")
    assert dec.decode_packets(batch) == [want[p] for p in batch]
    k9, k32 = (p.shape for p in _progs())
    assert k9 == (32, WIDTH[depth], 9) and k32 == (32, WIDTH[depth], 32)  # 31 packets


@pytest.mark.parametrize("depth", [16, 24])
def test_two_calls_in_flight_on_one_key(depth):
    """Two decode_async calls on one key, both made before either is
    finished: each handle holds its own outputs."""
    pc, pk, _, want = _case(depth)
    dec = TorchBatchDecoder(pc, "cpu")
    a, b = pk[:33], pk[10:43]
    ha = dec.decode_async(a, rows=ROWS)
    hb = dec.decode_async(b, rows=ROWS)
    assert [p.uses for p in _progs()] == [2]
    assert dec.finish_async(hb, b) == [want[p] for p in b]
    assert dec.finish_async(ha, a) == [want[p] for p in a]


def test_cache_keeps_at_most_max_programs(case, monkeypatch):
    """Keys whose pools pass the budget leave the budget's worth of
    programs, the least recently used released; an evicted key decodes
    correctly again.  Each program's pool is set to 100 bytes at its first
    use and the budget to 8 pools' worth."""
    pc, pk, _, want = case
    pool_at_first_use(monkeypatch, lambda prog: 100)
    monkeypatch.setattr(program, "BUDGET", 8 * 100)
    one = [max(pk, key=len)]
    dec = TorchBatchDecoder(pc, "cpu")
    rows = [8, 12, 16, 24, 32, 48, 64, 96, 128]
    first = None
    for r in rows:
        assert _decode(dec, one, rows=r) == [want[one[0]]]
        first = first or _progs()[0]
    assert [p.shape[0] for p in _progs()] == rows[1:]
    assert program.counts("cpu")["resident_bytes"] == 800
    assert first.released and first.inputs is None
    assert _decode(dec, one, rows=rows[0]) == [want[one[0]]]
    assert [p.shape[0] for p in _progs()] == rows[2:] + rows[:1]


def pool_at_first_use(monkeypatch, size):
    """Give each program a pool of ``size(program)`` bytes once it has run,
    as a capture on the card would (a CPU program has none)."""
    real = program.Program.run

    def run(self, sources):
        out = real(self, sources)
        if self.pool_bytes is None:
            self.pool_bytes = size(self)
        return out

    monkeypatch.setattr(program.Program, "run", run)


def test_launches_recorded_while_capturing_stay_on_the_thread():
    """A capture's launches go to the capturing thread's record, not to
    the counters; another thread's launches meanwhile count as before."""
    _build.reset_launch_counts()
    try:
        with _build.recording_launches() as rec:
            _build.count_launch("packet")
            _build.count_launch("lpc", 2)
            t = threading.Thread(target=_build.count_launch, args=("raw_read",))
            t.start()
            t.join(10)
            assert not t.is_alive()
        _build.count_launch("replay")
        assert rec == {"packet": 1, "lpc": 2}
        counts = _build.launch_counts()
        assert (counts["packet"], counts["lpc"], counts["raw_read"], counts["replay"]) == (
            0, 0, 1, 1)
    finally:
        _build.reset_launch_counts()


@pytest.mark.parametrize("fn", [shl, ushr, sshr, sext])
def test_constant_shift_counts_match_tensor_counts(fn):
    """The epilogue's constant shifts take Python counts, which make no
    host tensor (a CUDA graph capture refuses the copy of one to the card):
    each helper gives the same values as with a tensor count."""
    rng = np.random.default_rng(7)
    edge = [0, 1, -1, 0x7FFFFFFF, -0x80000000, 0xFFFF, -0x10000]
    x = torch.from_numpy(np.concatenate([
        edge, rng.integers(-(1 << 31), 1 << 31, 64)]).astype(np.int64))
    for n in (-1, 0, 1, 4, 8, 16, 24, 31, 32, 33, 40):
        got = fn(x, n)
        want = fn(x, torch.full_like(x, n))
        assert got.dtype == want.dtype and torch.equal(got, want), n
