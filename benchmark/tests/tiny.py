"""Cells at a size the CPU runs in seconds: the configuration and traffic
files of BENCHMARK.json's cells, with a shorter frame and less traffic."""

import time

from benchmark import harness

#: (configuration overrides, traffic overrides) of each cell on the CPU.
TINY = {
    "cd16_stereo.batch2048": ({"frame_length": 256},
                              {"packets": 8, "check_packets": 4, "check_mib": 1}),
    "surround71_24.batch2048": ({"frame_length": 256},
                                {"packets": 4, "check_packets": 2, "check_mib": 1}),
}


def tiny_cell(name: str):
    bench = harness.spec()
    work = harness.cell(bench, name)
    cfg_over, tr_over = TINY[name]
    config = dict(harness.config_file(bench, work["config"]), **cfg_over)
    traffic = dict(harness.traffic_file(work["traffic"]), **tr_over)
    return bench, work, config, traffic


def tiny_run(name: str, seed: int = 2**31 + 7, traced: bool = False, control: bool = False,
             seconds: float = 0.2, device: str = "cpu", **traffic):
    bench, work, config, tr = tiny_cell(name)
    return harness.run_cell(work, config, dict(tr, **traffic), seed, seconds, traced,
                            harness.metrics_for(bench, name, traced), time.perf_counter(),
                            device=device, control=control)
