"""One run of one cell: find its files by name, check the cards, set up,
measure the window, check the outputs against the reference, read the
metrics, print the result.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name `BENCHMARK.json` gives it:
`configs/<config>.json`, `traffic/<traffic>.json` (data; its ``kind``
names the loop that reads it, `loops/<kind>.py`, as `loads.py` sets out),
`metrics/<metric>.py` (a ``read(ctx)`` that returns a number, or None where
it finds nothing to read) and `roofline/<kernel>.py` (the bytes a kernel
needs).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace

from . import guard

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str, here: Path = HERE) -> dict:
    return load_json(here / "traffic" / f"{name}.json")


def module(folder: str, name: str, here: Path = HERE):
    """``<folder>/<name>.py`` loaded by its path (names may hold dots)."""
    path = here / folder / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's metrics: its end-to-end ones untraced, its per-layer ones
    traced; a metric without ``workloads`` belongs to every cell."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


@dataclass
class Context:
    """What a metric reader reads."""

    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    records: list  # one dict a call or request of the window
    trace: object | None  # trace.Trace of a traced run
    shapes: SimpleNamespace | None  # one call's kernel inputs, for rooflines
    device_kind: str


def run_cell(work: dict, config: dict, traffic: dict, seed: int, seconds: float, traced: bool,
             metrics: list[dict], start: float, device: str = "cuda",
             control: bool = False) -> dict:
    """Set up, measure and check one run; returns the result object (and,
    under ``"checks"``, each number compared with its limit)."""
    import saprobe_alac_tpu_torch as port
    import torch

    from . import loads, reference

    load = module("loops", traffic["kind"]).Load(port, config, traffic, seed, device)
    load.setup()
    if control:
        load.set_control()
    cards = list(range(torch.cuda.device_count())) if device == "cuda" else []
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    setup_s = time.perf_counter() - start
    before = _program_counts(port, cards)
    tr = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        from . import trace

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cards else [])
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW):
                win = load.window(seconds, True)
            if cards:
                loads.sync_all()
        t0 = time.perf_counter()
        tr = trace.read(prof, cards)
        loads.say(f"trace: {len(tr.ops)} device operations read in "
                  f"{time.perf_counter() - t0:.3f} s")
    else:
        win = load.window(seconds, False)
    records = win.records
    ms = sorted(r["ms"] for r in records)
    q = [ms[int(f * (len(ms) - 1))] for f in (0, 0.25, 0.5, 0.75, 1)] if ms else []
    loads.say(f"window: {len(records)} in {win.window_s:.3f} s; ms min, quartiles, max "
         f"{[round(v, 2) for v in q]}, first {[round(r['ms'], 2) for r in records[:4]]}; "
         f"programs before {before}, after {_program_counts(port, cards)}")
    peak = max((torch.cuda.max_memory_allocated(i) for i in cards), default=0)
    load.release()
    if cards:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    found = load.check(win)
    loads.say(f"check: {found} in {time.perf_counter() - t0:.3f} s")
    ctx = Context(work, config, traffic, setup_s, win.window_s, records, tr, load.shapes(),
                  torch.cuda.get_device_name(0) if cards else "cpu")
    values = {}
    for m in metrics:
        v = module("metrics", m["name"]).read(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": reference.LIMITS[k]}
              for k, v in found.items() if k in reference.LIMITS}
    correct = found["compared_bytes"] > 0 and all(c["value"] <= c["limit"]
                                                  for c in checks.values())
    dev = {"platform": "gpu" if cards else "cpu", "kind": ctx.device_kind, "count": len(cards),
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(records),
              "failed": sum(load.failed(r) for r in records), "metrics": values, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_by_host()}
    errors = [r["error"] for r in records if "error" in r]
    result["notes"] = {k: v for k, v in found.items() if k not in checks}
    result["notes"]["errors"] = errors[:3]
    result["checks"] = checks
    return result


def _program_counts(port, cards: list[int]) -> dict:
    """The program cache's counters of each card (programs made, eager
    runs, captures, replays): a capture inside the window shows here."""
    program = importlib.import_module(port.__name__ + ".ops.program")
    return {i: {k: v for k, v in program.counts(f"cuda:{i}").items() if k != "resident_bytes"}
            for i in cards}


def main(argv: list[str], start: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = spec()
    work = cell(bench, args.workload)
    config = config_file(bench, work["config"])
    traffic = traffic_file(work["traffic"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"{args.workload} needs {work['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(work, config, traffic, args.seed, args.seconds, bool(args.trace),
                      metrics_for(bench, args.workload, bool(args.trace)), start)
    blocked = guard.loaded()
    if blocked:
        print(f"blocked modules were loaded: {', '.join(blocked)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
