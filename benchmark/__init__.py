"""The benchmark of saprobe_alac_tpu_torch, the PyTorch and CUDA ALAC decoder.

`run.py` runs one cell of `BENCHMARK.json` once and prints one JSON line.
Everything the yardstick needs lives here: the inputs made from the seed
(`inputs.py`, with a frozen copy of the C++ encoder in `native/`), the
plain reference that decides `correct` (`reference.py`), one loop a kind of
traffic (`loops/<kind>.py`, sharing `loads.py`), the reading of the device
trace (`trace.py`), the peak table (`peaks.py`), one reader a metric
(`metrics/<name>.py`) and one byte count a kernel (`roofline/<kernel>.py`).
Configurations and traffic mixes are data (`configs/<name>.json`,
`traffic/<name>.json`), found by the names `BENCHMARK.json` gives.

Nothing here imports JAX or the JAX package; only the loops call the system
under test, through its public entry points.
"""
