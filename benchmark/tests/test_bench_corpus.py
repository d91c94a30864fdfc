"""The library ingest cell, `lossless_library.ingest12` (`loops/corpus.py`):
the frozen M4A writer's files demux through the port to what was written,
a sound run is correct, and the control and three faults planted in what
`iter_decode_corpus` yields are not; the readers of the service's spans.

A tiny corpus at F=256 on the CPU: two 16-bit tracks of 150 packets (one
group of 300, so a full batch of the default 256 and a partial tail run)
and one 24/48 track, every packet of every file checked.  The sound run
runs the port's plain versions; the control and the faults, which test the
check and not the decode, run the service on the C++ core.  The control at
the cell's own size runs on a card."""

import time

import pytest

from benchmark import harness, inputs, loads, m4a
from benchmark.tests.test_bench_metrics import ctx, metric, synthetic_trace
from benchmark.tests.test_bench_port_spans import one_call, recorded, sp  # noqa: F401

import saprobe_alac_tpu_torch as port

NAME = "lossless_library.ingest12"
SEED = 2**33 + 11


def tiny_corpus():
    bench = harness.spec()
    work = harness.cell(bench, NAME)
    config = dict(harness.config_file(bench, work["config"]), frame_length=256, track_s=0.87)
    config["tiers"] = [dict(config["tiers"][0], tracks=2), dict(config["tiers"][1], tracks=1)]
    traffic = dict(harness.traffic_file(work["traffic"]), check_packets=256, check_mib=16)
    return bench, work, config, traffic


def corpus_run(device="cpu", control=False, traced=False, seed=SEED):
    bench, work, config, traffic = tiny_corpus()
    return harness.run_cell(work, config, traffic, seed, 0.1, traced,
                            harness.metrics_for(bench, NAME, traced), time.perf_counter(),
                            device=device, control=control)


def test_the_tiny_corpus_batches_as_the_cell_does():
    from benchmark.loops import corpus

    _, _, config, _ = tiny_corpus()
    tracks = corpus.track_configs(config)
    packets = [-(-round(0.87 * c["sample_rate"]) // 256) for c in tracks]
    assert packets == [150, 150, 164] and sum(packets[:2]) > 256 > packets[2]


@pytest.mark.parametrize("tier", range(4))
def test_the_writers_files_demux_to_the_config_and_packets(tier, tmp_path):
    from benchmark.loops import corpus

    bench = harness.spec()
    config = dict(harness.config_file(bench, "lossless_library"), frame_length=256)
    cfg = [c for c in corpus.track_configs(config) if c["sample_rate"] == (
        44100, 48000, 96000, 192000)[tier]][0]
    n = 5 * 256 + 77
    _, packets = inputs.track(cfg, n, seed=2**32 + tier)
    path = tmp_path / "t.m4a"
    size = m4a.write_m4a(path, cfg, packets, [256] * 5 + [77])
    blob = path.read_bytes()
    assert size == len(blob) and blob.endswith(b"mdat" + b"".join(packets))
    with open(path, "rb") as f:
        got, samples = port.demux_stream(f)
        read = []
        for s in samples:
            f.seek(s.offset)
            read.append(f.read(s.size))
    assert got == loads.packet_config(port, cfg)
    assert read == packets


def test_sound_run_is_correct():
    out = corpus_run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == 3 * out["notes"]["passes"]
    assert out["notes"]["files_checked"] == out["attempted"]
    assert out["notes"]["files_missing"] == 0 and out["notes"]["fallback_packets"] == 0


def test_control_is_not_correct():
    out = corpus_run("native", control=True)
    assert not out["correct"] and out["checks"]["bad_bytes"]["value"] > 0
    assert out["failed"] == 0


def _planted(monkeypatch, change):
    """`iter_decode_corpus` with ``change`` applied to each pass's files."""
    real = port.iter_decode_corpus

    def planted(*args, **kwargs):
        yield from change(list(real(*args, **kwargs)))

    monkeypatch.setattr(port, "iter_decode_corpus", planted)


def altered_byte(files):
    """One byte altered in the middle of the first file."""
    f = files[0]
    pcm = bytearray(f.pcm)
    pcm[len(pcm) // 2] ^= 1
    return [port.DecodedFile(f.source, f.format, bytes(pcm), f.index)] + files[1:]


def file_left_out(files):
    return files[:1] + files[2:]


def files_swapped(files):
    """The PCM of two files of the same length (the two 16-bit tracks)
    swapped, each keeping its index and format."""
    a, b = [i for i, f in enumerate(files) if f.format.bit_depth == 16]
    out = list(files)
    out[a] = port.DecodedFile(files[a].source, files[a].format, files[b].pcm, files[a].index)
    out[b] = port.DecodedFile(files[b].source, files[b].format, files[a].pcm, files[b].index)
    return out


@pytest.mark.parametrize("fault", [altered_byte, file_left_out, files_swapped])
def test_fault_is_not_correct(fault, monkeypatch):
    _planted(monkeypatch, fault)
    out = corpus_run("native")
    assert not out["correct"], out["checks"]


def test_service_span_readers_per_file(recorded):  # noqa: F811
    """demux_ms and join_ms: each one's own ms over the files joined in the
    window; the batch readers still count the top-level submits."""
    recorded += [sp(50, "alac.service.demux", 0, 2, packets=3, bytes=30),
                 sp(51, "alac.service.demux", 2, 5, packets=3, bytes=30)]
    recorded += one_call(0, 5)
    recorded += [sp(52, "alac.service.join", 106, 107, bytes=10),
                 sp(53, "alac.service.join", 107, 110, bytes=20)]
    c = ctx(trace=synthetic_trace())
    assert metric("demux_ms", c) is None  # the joins lie outside the 100 ms window
    recorded[-2:] = [sp(52, "alac.service.join", 96, 97), sp(53, "alac.service.join", 97, 99)]
    assert metric("demux_ms", c) == pytest.approx((2 + 3) / 2)
    assert metric("join_ms", c) == pytest.approx((1 + 2) / 2)
    assert metric("pack_ms", c) == pytest.approx(4.0)
    assert metric("join_ms", ctx(trace=None)) is None


CELL_SEEDS = [2**31 + 101, 2**31 + 202, 2**31 + 303]


@pytest.mark.chip
@pytest.mark.parametrize("seed", CELL_SEEDS)
def test_control_at_the_cells_own_size(seed, card, capsys):
    """The control, the reference one bit below the stated precision in the
    service's place, at the cell's own size and load on the card: it has to
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
