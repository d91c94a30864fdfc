"""What decides `correct`: the input maker and the reference agree, a sound
run of each cell is correct, and the control and each fault the cells can
have are not.  Runs the port's plain versions on the CPU at tiny sizes
(tiny.py); the control at each cell's own size runs on a card."""

import pytest

from benchmark import inputs, loads, reference
from tiny import TINY, tiny_cell, tiny_run

import saprobe_alac_tpu_torch as port
from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder


@pytest.mark.parametrize("name", ["cd16_stereo.batch2048", "surround71_24.batch2048"])
def test_input_maker_and_reference_agree(name):
    """The frozen encoder's packets decode, by the port's scalar oracle, to
    exactly the reference's bytes (a partial last packet included)."""
    _, _, config, _ = tiny_cell(name)
    pcm, packets = inputs.track(config, 3 * config["frame_length"] + 100, seed=2**31 + 3)
    got = port.BatchDecoder(loads.packet_config(port, config), "scalar").decode_packets(packets)
    assert got == reference.packet_bytes(config, pcm)
    assert reference.packet_bytes(config, reference.lower_precision(pcm)) != got


@pytest.mark.parametrize("name", sorted(TINY))
def test_sound_run_is_correct(name):
    out = tiny_run(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert out["notes"]["calls_checked"] == out["attempted"]


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_is_not_correct(name):
    out = tiny_run(name, control=True)
    assert not out["correct"] and out["checks"]["bad_bytes"]["value"] > 0


def test_the_sample_is_seeded_spread_over_the_window_and_keeps_odd_answers():
    """A buffer of 5 calls over 200: a seeded uniform sample of them all;
    an answer missing or of another length is kept as it came."""
    from benchmark.loops import batch as loop

    def kept(seed):
        s = loop.Sample(seed, batch=8, per_call=3, packet_bytes=4, mib=5 * 12 / 2**20)
        for k in range(200):
            s.offer(k, k % 16, [bytes([k % 251] * 4)] * 4 + [b"x"] * 4)
        return s

    s = kept(2**40 + 1)
    calls = sorted(k for k, *_ in s.kept.values())
    assert len(calls) == s.slots == 5 and calls[-1] >= 100
    assert calls == sorted(k for k, *_ in kept(2**40 + 1).kept.values())
    for slot, (k, _, pos, odd, extra) in s.kept.items():
        assert extra == 0 and sorted(odd) == [j for j, p in enumerate(pos) if p >= 4]
        assert all(odd[j] == b"x" for j in odd)
        assert all(bytes(s.buf[slot, j]) == bytes([k % 251] * 4) for j in range(3) if j not in odd)


def altered_answer(monkeypatch):
    """One byte of one packet altered where the bytes are produced."""
    to_bytes = TorchBatchDecoder._to_bytes

    def wrong(self, row, ns):
        b = bytearray(to_bytes(self, row, ns))
        b[len(b) // 2] ^= 1
        return bytes(b)

    monkeypatch.setattr(TorchBatchDecoder, "_to_bytes", wrong)


def half_the_batch(monkeypatch):
    """Half of the batch left out: only the first half's bytes return."""
    finish = TorchBatchDecoder.finish_async
    monkeypatch.setattr(TorchBatchDecoder, "finish_async",
                        lambda self, h, p: finish(self, h, p)[: len(p) // 2])


def unchanged_state(monkeypatch):
    """A call that returns the previous call's bytes, its state unchanged."""
    finish, last = TorchBatchDecoder.finish_async, {}

    def stale(self, h, p):
        out = finish(self, h, p)
        prev = last.get(len(p), out)
        last[len(p)] = out
        return prev

    monkeypatch.setattr(TorchBatchDecoder, "finish_async", stale)


@pytest.mark.parametrize("name, fault", [
    ("cd16_stereo.batch2048", altered_answer),
    ("cd16_stereo.batch2048", half_the_batch),
    ("cd16_stereo.batch2048", unchanged_state),
    ("surround71_24.batch2048", altered_answer),
    ("surround71_24.batch2048", half_the_batch),
    ("surround71_24.batch2048", unchanged_state),
])
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = tiny_run(name, seconds=0.5)
    assert not out["correct"], out["checks"]


CELL_SEEDS = [2**31 + 101, 2**31 + 202, 2**31 + 303]


@pytest.mark.chip
@pytest.mark.parametrize("seed", CELL_SEEDS)
@pytest.mark.parametrize("name", sorted(TINY))
def test_control_at_the_cells_own_size(name, seed, card, capsys):
    """The control, the reference one bit below the stated precision in the
    program's place, at the cell's own size and load on the card: it has to
    come out as not correct."""
    import time

    from benchmark import harness

    bench, work, config, _ = tiny_cell(name)
    if card < work["chips"]:
        pytest.skip(f"needs {work['chips']} cards")
    config = harness.config_file(bench, work["config"])
    traffic = harness.traffic_file(work["traffic"])
    # A whole window, so that it compares as many calls as a run does.
    out = harness.run_cell(work, config, traffic, seed, bench["run_seconds"], False,
                           harness.metrics_for(bench, name, False), time.perf_counter(),
                           control=True)
    with capsys.disabled():
        print(f"control {name} seed {seed}: correct {out['correct']} checks {out['checks']} "
              f"notes {out['notes']}")
    assert not out["correct"]
