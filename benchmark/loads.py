"""What every traffic loop shares.  A loop is a file of its own,
`loops/<kind>.py`, found by the ``kind`` a traffic file names, with a class
``Load(port, config, traffic, seed, device)`` that has:

- ``setup()``: make the inputs, build the decoder, run every shape the
  window will use until it replays;
- ``window(seconds, traced)``: run until ``seconds`` have passed and the
  call in flight has completed; returns ``SimpleNamespace(window_s,
  records)``, one dict a call or request with at least ``ms`` and ``done``;
- ``failed(record)``, ``release()`` (drop the program's state),
  ``set_control()`` (put the control in the program's place),
  ``check(window)`` (after the window: each number compared, by name, and
  ``compared_bytes``) and ``shapes()`` (what one call gives the kernels, for
  the roofline files, or None).

Loops are the only code that calls the system under test, through its
public entry points, with default arguments.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np

from . import inputs


def span(traced: bool, name: str):
    """A harness span (`trace.SPAN_PREFIX`) in a traced run, else nothing."""
    if not traced:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(f"bench.{name}")


def sync_all():
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def say(line: str) -> None:
    """A line of diagnosis on standard error (the result goes to standard output)."""
    print(line, file=sys.stderr, flush=True)


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator for one use (``stream``) of a loop."""
    return np.random.default_rng([inputs.pcm_seed(seed), stream])


def input_device(device: str):
    """Where music_pcm makes the signal: on the card in a chip run, on the
    host in a CPU rehearsal."""
    return "cuda" if device == "cuda" else None


def packet_config(port, config: dict):
    """The port's `PacketConfig` of a configuration file."""
    return port.PacketConfig(**{k: config[k] for k in (
        "frame_length", "bit_depth", "num_channels", "pb", "mb", "kb", "max_run",
        "max_frame_bytes", "avg_bit_rate", "sample_rate")})
