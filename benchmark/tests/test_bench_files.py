"""The harness finds a configuration, a traffic mix and a metric by the
names BENCHMARK.json gives them: adding one takes new files and entries."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import harness, inputs

BENCH = harness.spec()


def test_every_name_resolves_to_its_file():
    for c in BENCH["configs"]:
        assert harness.config_file(BENCH, c["name"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        kind = harness.traffic_file(w["traffic"])["kind"]
        assert callable(harness.module("loops", kind).Load)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.module("metrics", m["name"]).read)
    for kernel in ("packet_kernel", "lpc_kernel", "raw_reader_kernel"):
        assert callable(harness.module("roofline", kernel).bytes_needed)


@pytest.mark.parametrize("trace", [False, True])
def test_each_cell_has_setup_another_end_to_end_and_a_per_layer_metric(trace):
    for w in BENCH["workloads"]:
        names = [m["name"] for m in harness.metrics_for(BENCH, w["name"], trace)]
        assert len(names) >= (1 if trace else 2)
        if not trace:
            assert "setup_s" in names


#: A loop of a new kind, as a later PR would add it: one packet a call.
ONE_BY_ONE = """
import time
from types import SimpleNamespace

from benchmark import inputs, reference
from benchmark.loads import packet_config


class Load:
    def __init__(self, port, config, traffic, seed, device):
        self.port, self.config, self.traffic, self.seed = port, config, traffic, seed
        self.device = device

    def setup(self):
        n = self.traffic["packets"] * self.config["frame_length"]
        self.pcm, self.pool = inputs.track(self.config, n, self.seed)
        self.dec = self.port.BatchDecoder(packet_config(self.port, self.config), self.device)
        self.got = []

    def window(self, seconds, traced):
        records, start = [], time.perf_counter()
        while not records or time.perf_counter() < start + seconds:
            t0, i = time.perf_counter(), len(records) % len(self.pool)
            self.got.append((i, self.dec.decode_packets([self.pool[i]])[0]))
            records.append({"ms": (time.perf_counter() - t0) * 1e3, "done": True,
                            "audio_s": self.config["frame_length"] / self.config["sample_rate"]})
        return SimpleNamespace(window_s=time.perf_counter() - start, records=records)

    def failed(self, record):
        return not record["done"]

    def release(self):
        self.dec = None

    def check(self, win):
        want = reference.packet_bytes(self.config, self.pcm)
        return {"bad_bytes": sum(reference.differing(b, want[i]) for i, b in self.got),
                "compared_bytes": sum(len(want[i]) for i, _ in self.got)}

    def shapes(self):
        return None
"""


def test_a_config_says_what_music_and_encoder_make_its_inputs():
    """The ``music`` and ``encoder`` groups of a configuration file are what
    the input maker uses: near-white noise, an order-8 predictor."""
    base = dict(harness.config_file(BENCH, "cd16_stereo"), frame_length=256)
    noise = dict(base, music={"tonality": 0.05}, encoder=dict(base["encoder"], order=8))
    pcm, packets = inputs.track(noise, 1024, seed=2**33 + 5)
    assert (pcm == inputs.music_pcm(1024, 2, 2**33 + 5, tonality=0.05)).all()
    assert not (pcm == inputs.track(base, 1024, seed=2**33 + 5)[0]).all()
    _, tonal8 = inputs.track(dict(base, encoder=noise["encoder"]), 1024, seed=2**33 + 5)
    header = int.from_bytes(tonal8[0][:8], "big")
    assert header >> (64 - 23) & 1 == 0  # not escaped: the predictor header follows
    assert header >> (64 - 55) & 0x1F == 8  # a pair's first predictor's order


def test_a_cell_added_as_files_only_runs(tmp_path):
    """New configurations, traffic mixes, a loop of a new kind and a
    per-layer metric, each a new file beside the existing ones, and new
    entries in a copy of BENCHMARK.json: the harness runs the new cells
    without a code change."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    base = harness.config_file(BENCH, "cd16_stereo")
    configs = {
        "cd8_mono": dict(base, name="cd8_mono", num_channels=1, layout=["SCE"], frame_length=256,
                         sample_rate=8000),
        "noise16": dict(base, name="noise16", frame_length=256, music={"tonality": 0.05},
                        encoder=dict(base["encoder"], order=8)),
    }
    for name, cfg in configs.items():
        (root / f"benchmark/configs/{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test", "reduced": [], "why": "a test",
                                 "file": f"benchmark/configs/{name}.json"})
    (root / "benchmark/traffic/batch4.json").write_text(json.dumps(
        {"kind": "batch", "packets": 4, "check_packets": 2, "check_mib": 1, "why": "4 a call"}))
    (root / "benchmark/traffic/one4.json").write_text(json.dumps(
        {"kind": "one_by_one", "packets": 4, "why": "one packet a call"}))
    (root / "benchmark/loops/one_by_one.py").write_text(ONE_BY_ONE)
    (root / "benchmark/metrics/calls_done.py").write_text(
        "def read(ctx):\n    return sum(c['done'] for c in ctx.records)\n")
    cells = {"cd8_mono.batch4": ("cd8_mono", "batch4"), "noise16.one4": ("noise16", "one4")}
    for name, (config, traffic) in cells.items():
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "a test"})
        bench["end_to_end"][0]["workloads"].append(name)
    bench["per_layer"].append({"name": "calls_done", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "batch", "moves": "decode_rate",
                               "workloads": sorted(cells)})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    # The copy's own harness, in a process of its own, finds the new files.
    code = (
        "import json, sys, time\n"
        "sys.path[:0] = [sys.argv[1], sys.argv[2]]  # the copy, then the port\n"
        "from benchmark import harness\n"
        "spec = harness.spec()\n"
        "out = {}\n"
        "for name in sys.argv[3:]:\n"
        "    work = harness.cell(spec, name)\n"
        "    config = harness.config_file(spec, work['config'])\n"
        "    traffic = harness.traffic_file(work['traffic'])\n"
        "    out[name] = [harness.run_cell(work, config, traffic, 5, 0.1, trace,\n"
        "                                  harness.metrics_for(spec, name, trace),\n"
        "                                  time.perf_counter(), device='cpu')\n"
        "                 for trace in (False, True)]\n"
        "print(json.dumps(out))\n"
    )
    r = subprocess.run([sys.executable, "-c", code, str(root), str(harness.ROOT), *cells],
                       capture_output=True, text=True, timeout=600, cwd=root)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for name in cells:
        plain, traced = out[name]
        assert plain["correct"] and set(plain["metrics"]) == {"decode_rate", "setup_s"}, plain
        assert traced["correct"] and traced["metrics"]["calls_done"]["value"] >= 1, traced
