"""Device programs shared by the whole process: static inputs and a
captured CUDA graph, one a key, under a memory budget.

Counterpart of the JAX package's module-level `jax.jit` executables (the
batch decode's `_decode_batch`, saprobe_alac_tpu/ops/batch.py:78-138;
`encode_walk`, ops/encode_device.py:455-470; the audio features,
ops/audio.py:16, 29, 39): XLA compiles one
executable per (static arguments, shapes) and every caller in the process
reuses it.  Here a `Program` holds one key's input tensors on its device
and, on a CUDA device, one `torch.cuda.CUDAGraph` of its core (a pure
function of device tensors: no host sync, no host-to-device copy), so a
warm call is one graph replay instead of tens to hundreds of launches.

The key is (device, kind, statics, shape): the core's kind ("decode",
"encode_walk", a feature's name), the static arguments it binds (for the
decode, the config's F, C, depth, pb, mb and kb: sample rate, max_run,
max_frame_bytes and avg_bit_rate do not enter) and its shapes.  Every
decoder or caller with the same key on the same device runs one program.

A program's life on a CUDA device:

- first use: the core runs eagerly on the caller's data (a device tensor
  of the input's shape as it is, anything else copied into a zeroed
  tensor that the call drops), and the program keeps nothing.  That run
  loads the kernels' libraries, builds cuFFT's plans and settles the
  allocator, which capture needs, and its outputs are the call's result;
- second use: the program allocates its static inputs, fills them, and
  captures the core on them (`capture_error_mode="thread_local"`, so
  another thread's pinned allocation does not break it) on a stream of
  its own, with a memory pool of its own, then replays it;
- every later use: one replay.  A capture that fails raises: nothing runs
  the core another way.

On the CPU the second use allocates the static inputs as on the card and
every use from then on runs the core eagerly on them, so the CPU tests
reach the fill code that a replay reads.

From its second use `run` enqueues, on the caller's current stream: a
wait on the event recorded after the program's previous clones (another
thread's stream may still read the static inputs or outputs), the fill of
the static inputs (non-blocking: host arrays are staged before the copy
returns, device tensors are copied on the device), the core, and a clone
of its outputs.  The clone makes a result independent of the program: a
later call, or the program's release, never changes it.

Memory: what a program keeps is its static inputs and, on a card, its
graph's pool, which holds the outputs and every temporary of the core
(809 MB for 16-bit stereo at B=2048, 4.25 GB for 7.1: chip_smoke.py phase
22 on an NVIDIA H100 80GB HBM3 at 700 W); a key used once keeps nothing.
The cache holds those bytes (`Program.resident_bytes`) to `budget`
bytes a device: `BUDGET` if set, else a quarter of the card's total memory,
read at first use (21,254,373,376 bytes on an H100 80GB HBM3), or
`HOST_BUDGET` (1 GiB) on the CPU; and it holds at most `MAX_KEYS`
programs a device, since a key used once still takes an entry.  After a
run leaves more than that, the least recently used programs of the device
are released, never the one that just ran nor the most recently used one,
so the resident bytes stay within the budget plus the largest single
program's.  A released pool goes back to PyTorch's caching allocator,
which returns it to the card at `torch.cuda.empty_cache()` or when an
allocation would otherwise fail.

Tracing: while a torch.profiler session records, `run` records an
``alac.program.dispatch`` span (the lookup, the wait on the previous
clones, the eager run, capture or replay, named in its ``ran`` attribute,
the clones and the settling) and, inside it, an ``alac.program.wait`` span
around the taking of the program's lock (the time another caller of the
same key holds it: 0 for a single caller) and an ``alac.program.fill``
span around the copy of the sources into the program's inputs, whose
``bytes`` attribute counts what it copied from the host (utils/profiling.py).
The counters (`counts`) add those bytes up as ``upload_bytes``, whether or
not a profiler records; `add_counts` takes the batch layer's own.

Locks: the cache's lock guards the table and the counters; each program's
own lock its fill, run and clone.  They are taken one at a time, never
nested: a program is released under its own lock after the cache's lock
let it go, and a released program never runs (`run` looks the key up
again).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Sequence

import numpy as np
import torch

from .. import _build
from ..utils.profiling import DISPATCH, FILL, WAIT, span

#: Bytes of programs (static inputs and graph pools) the cache keeps
#: resident a device; None: a quarter of the card's total memory, read at
#: first use (21,254,373,376 bytes on an H100 80GB HBM3), `HOST_BUDGET` on
#: the CPU.
BUDGET: int | None = None
HOST_BUDGET = 1 << 30
#: Programs the cache keeps a device, whatever their bytes.
MAX_KEYS = 1024

#: What `counts` reports a device: programs made, eager runs, captures,
#: replays (a capture's own replay included), programs evicted, and bytes
#: copied from the host into programs' inputs; then the batch layer's
#: (`add_counts`): batch calls submitted (a sharded call: one a shard) and
#: their packets, packets decoded on the host, 32-tap retries, bytes the
#: trim copied from the downloaded rows, and padded packs into a pooled
#: staging buffer and into a new one; then the corpus service's: files
#: yielded, batches it dispatched, those of them under its batch size,
#: decoders it made (one a config group) and its reads of the containers;
#: then the streaming facade's:
#: decoders opened, windows dispatched and dispatched windows dropped
#: unread (by a seek, or with their decoder).
_COUNTERS = ("programs", "eager", "captures", "replays", "evictions", "upload_bytes", "calls",
             "packets", "fallback_packets", "wide_retries", "trim_bytes", "staging_reuses",
             "staging_allocs", "files", "service_batches", "partial_batches", "groups",
             "service_reads", "decoder_opens", "decoder_windows", "prefetch_dropped")

_lock = threading.Lock()
#: Every device's programs by key, least recently used first.
_programs: OrderedDict[tuple, Program] = OrderedDict()
_counts: dict[torch.device, dict[str, int]] = {}
_totals: dict[torch.device, int] = {}


class Program:
    """One key's core on one device.  ``key``: (device, kind, statics,
    shape); ``core`` maps the static input tensors to a tuple of output
    tensors; ``specs``: the static inputs' (shape, dtype)."""

    def __init__(self, key: tuple, core: Callable, specs: Sequence[tuple]):
        self.key = key
        self.device, self.kind, self.statics, self.shape = key
        self.core = core
        self.specs = tuple((tuple(s), d) for s, d in specs)
        self.lock = threading.Lock()
        #: The static inputs, allocated at the second use.
        self.inputs = None
        self.uses = 0
        self.released = False
        self.graph = None
        self.outputs = None
        #: Launches per kernel that one replay enqueues (recorded at capture).
        self.launches: dict[str, int] = {}
        self.capture_ms = None
        #: Bytes the card reserved for the graph's memory pool at capture (the
        #: rise of torch.cuda.memory_reserved: the pool takes new segments).
        self.pool_bytes = None
        #: Bytes the last run copied from the host into the inputs.
        self.uploaded = 0
        self._done = None  # event after the last call's clones (CUDA)

    @property
    def resident_bytes(self) -> int:
        """The bytes the program keeps: its static inputs and its pool."""
        inputs = self.inputs or ()
        return sum(t.numel() * t.element_size() for t in inputs) + (self.pool_bytes or 0)

    def run(self, sources: Sequence) -> tuple[tuple, tuple]:
        """Run the core on ``sources`` (numpy arrays or tensors, each the
        leading rows of its input) and return (its outputs, fresh tensors
        of the caller's, and what ran: "eager", or "capture" and "replay",
        or "replay").  The caller holds the lock."""
        self.uses += 1
        self.uploaded = 0
        sources = [torch.from_numpy(s) if isinstance(s, np.ndarray) else s for s in sources]
        if self.uses == 1:
            return tuple(self.core(*self._staged(sources))), ("eager",)
        if self.device.type != "cuda":
            if self.inputs is None:
                self._allocate()
            self._fill(self.inputs, sources)
            return tuple(t.clone() for t in self.core(*self.inputs)), ("eager",)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device)
            ran = ("replay",)
            if self.graph is None:
                self._allocate()
                self._fill(self.inputs, sources)
                self._capture()
                ran = ("capture", "replay")
            else:
                stream.wait_event(self._done)
                self._fill(self.inputs, sources)
            self.graph.replay()
            for name, n in self.launches.items():
                _build.count_launch(name, n)
            _build.count_launch("replay")
            out = tuple(t.clone() for t in self.outputs)
            self._done.record(stream)
        return out, ran

    def _staged(self, sources: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The first use's inputs: a source that is already a tensor of its
        input's shape, dtype and device as it is, any other copied into the
        leading rows of a zeroed tensor."""
        inputs = [src if (tuple(src.shape), src.dtype, src.device) == (shape, dtype, self.device)
                  else torch.zeros(shape, dtype=dtype, device=self.device)
                  for (shape, dtype), src in zip(self.specs, sources)]
        self._fill(inputs, sources)
        return inputs

    def _allocate(self) -> None:
        """The static inputs, zeroed, on the caller's current stream (a
        later caller on another stream waits on `_done`)."""
        self.inputs = tuple(torch.zeros(s, dtype=d, device=self.device) for s, d in self.specs)
        if self.device.type == "cuda":
            self._done = torch.cuda.Event()

    def _fill(self, inputs: Sequence[torch.Tensor], sources: Sequence[torch.Tensor]) -> None:
        """Copy each source into the leading rows of its input (a source
        that is its input is left as it is), counting the host's bytes."""
        # Non-blocking: a copy from pageable memory returns once CUDA has
        # staged the host bytes, without waiting for the stream's earlier
        # work, so the lock is held for the enqueue alone.
        with span(FILL) as s:
            for dst, src in zip(inputs, sources):
                if dst is not src:
                    dst[: len(src)].copy_(src, non_blocking=True)
                    self.uploaded += _host_bytes(src)
            if s.recording:
                s.set(bytes=self.uploaded)

    def _capture(self) -> None:
        """Capture the core on the static inputs into a CUDA graph with a
        memory pool of its own, on a stream of its own.  Unlike
        `torch.cuda.graph`, no device synchronise, garbage collection or
        `empty_cache` first: a capture costs about one eager call.  Raises
        if the capture fails."""
        before = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with _build.recording_launches() as launches, torch.cuda.stream(
                torch.cuda.Stream(self.device)):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = tuple(self.core(*self.inputs))
            finally:
                graph.capture_end()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - before
        self.graph, self.outputs, self.launches = graph, outputs, launches

    def release(self) -> None:
        """Drop the graph, its outputs and the static inputs, once the last
        call's clones are done (its work may be in flight on another
        stream).  The caller holds the lock; the program never runs again."""
        if self._done is not None:
            self._done.synchronize()
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.outputs = self.inputs = None
        self.released = True


def _host_bytes(src: torch.Tensor) -> int:
    """The bytes of a source copied from host memory (0 from a card)."""
    return src.numel() * src.element_size() if src.device.type == "cpu" else 0


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def budget(device) -> int:
    """The bytes of programs the cache keeps resident on ``device``:
    `BUDGET`, or a quarter of the card's total memory, or `HOST_BUDGET` on
    the CPU."""
    device = _device(device)
    if BUDGET is not None:
        return BUDGET
    if device.type != "cuda":
        return HOST_BUDGET
    if device not in _totals:
        _totals[device] = torch.cuda.get_device_properties(device).total_memory
    return _totals[device] // 4


def run(device, kind: str, statics: tuple, shape: tuple,
        make: Callable[[torch.device], tuple[Callable, Sequence[tuple]]],
        sources: Sequence) -> tuple:
    """Run the program of (``device``, ``kind``, ``statics``, ``shape``) on
    ``sources`` and return its outputs; ``make(device)`` gives a new
    program's (core, input (shape, dtype)s) when the cache has none."""
    key = (_device(device), kind, statics, shape)
    with span(DISPATCH) as s:
        while True:
            with _lock:
                prog = _programs.get(key)
                if prog is None:
                    prog = _programs[key] = Program(key, *make(key[0]))
                    _counter(key[0])["programs"] += 1
                else:
                    _programs.move_to_end(key)
            with span(WAIT):
                prog.lock.acquire()
            try:
                if prog.released:  # evicted since the lookup: look it up again
                    continue
                out, ran = prog.run(sources)
                uploaded = prog.uploaded
            finally:
                prog.lock.release()
            _settle(prog, ran, uploaded)
            if s.recording:
                s.set(kind=kind, ran=ran)
            return out


def _counter(device: torch.device) -> dict[str, int]:
    return _counts.setdefault(device, dict.fromkeys(_COUNTERS, 0))


def _settle(prog: Program, ran: tuple, uploaded: int) -> None:
    """Count what ``prog``'s run did (``uploaded``: the bytes it copied
    from the host), then release the device's least
    recently used programs while they keep more than the budget's bytes
    (the programs that keep nothing stay) or are more than `MAX_KEYS`."""
    victims = []
    with _lock:
        counter = _counter(prog.device)
        for what in ran:
            counter[{"capture": "captures", "replay": "replays"}.get(what, what)] += 1
        counter["upload_bytes"] += uploaded
        mine = [p for p in _programs.values() if p.device == prog.device]
        total = sum(p.resident_bytes for p in mine)
        over_bytes, over_keys = total - budget(prog.device), len(mine) - MAX_KEYS
        for p in mine[:-1]:  # the most recently used stays
            if over_bytes <= 0 and over_keys <= 0:
                break
            held = p.resident_bytes
            if p is prog or (over_keys <= 0 and not held):
                continue
            victims.append(p)
            over_bytes -= held
            over_keys -= 1
            del _programs[p.key]
        counter["evictions"] += len(victims)
    for p in victims:
        with p.lock:
            p.release()


def programs(device=None) -> list[Program]:
    """The cached programs (of ``device``, or of every device), least
    recently used first."""
    with _lock:
        progs = list(_programs.values())
    if device is None:
        return progs
    device = _device(device)
    return [p for p in progs if p.device == device]


def counts(device) -> dict[str, int]:
    """``device``'s counters since the last `reset_counts`, with the bytes
    its cached programs keep now (``resident_bytes``: static inputs and
    pools) and how many they are (``cached``)."""
    device = _device(device)
    with _lock:
        mine = [p for p in _programs.values() if p.device == device]
        return {**_counter(device), "resident_bytes": sum(p.resident_bytes for p in mine),
                "cached": len(mine)}


def add_counts(device, **added: int) -> None:
    """Add to ``device``'s counters (names from `_COUNTERS`)."""
    device = _device(device)
    with _lock:
        counter = _counter(device)
        for name, n in added.items():
            counter[name] += n


def reset_counts() -> None:
    with _lock:
        _counts.clear()


def clear() -> None:
    """Release every cached program (a test's or a measurement's clean
    start); the counters stay."""
    with _lock:
        progs = list(_programs.values())
        _programs.clear()
    for p in progs:
        with p.lock:
            p.release()
