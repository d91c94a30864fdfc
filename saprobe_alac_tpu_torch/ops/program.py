"""One batch shape's decode program: static inputs and a captured CUDA graph.

Counterpart of the JAX package's per-bucket executables, the jitted
`_decode_batch` and `_decode_batch_tight` (saprobe_alac_tpu/ops/batch.py:
78-138): XLA compiles one program per (config, batch bucket, width bucket,
taps) and reuses it across calls.  Here a `DecodeProgram` holds one key's
input tensors on the device and, on a CUDA device, one `torch.cuda.CUDAGraph`
of the decode (`batch._decode_core`: the walk, the LPC lanes and kernel, the
shift reads and the epilogue), so a warm batch is one graph replay instead
of about a hundred launches.

A program's life on a CUDA device:

- first use: the decode runs eagerly on the static inputs.  That run loads
  the kernels' libraries and settles the allocator, which capture needs, and
  its outputs are the call's result, so a first batch pays no capture;
- second use: the decode is captured (`capture_error_mode="thread_local"`,
  so another thread's pinned allocation does not break it) on a stream of
  its own, then replayed;
- every later use: one replay.

On the CPU every use runs the decode eagerly on the same static inputs, so
the CPU tests reach the fill code that a replay reads.

A caller (`TorchBatchDecoder`) holds its lock around `run`; `run` then
enqueues, on the caller's current stream: a wait on the event recorded after
the previous call's clones (another thread's stream may still be reading the
static inputs or outputs), the fill of the static inputs, the decode, and a
clone of the four outputs.  The clone makes a handle independent of the
program: a later call, or the program's eviction, never changes it.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from .. import _build

#: Programs a decoder keeps; the least recently used beyond this is dropped
#: with its graph and memory pool.
MAX_PROGRAMS = 8


def payload(host: tuple) -> tuple:
    """The host arrays a call uploads, from `TorchBatchDecoder._host_stage`'s
    tuple: padded, (words (rows, W), size_bits); tight, (the flat buffer's
    packet words, word offsets, size_bits).  The tight buffer's words past
    the last packet are not uploaded: a row is zero at and past its packet's
    last word (`batch._tight_rows`), and padding rows have size 0, so no row
    reads them and the stale words a longer earlier call left there are
    never seen."""
    if len(host) == 2:
        return host
    flat, starts, sizes, _ = host
    words = int(((sizes.astype(np.int64) + 31) >> 5).sum())
    return flat[:words], starts, sizes


class DecodeProgram:
    """One key's decode on one device.  ``key``: (rows, W, taps, tight,
    flat words): the batch's rows, its row width in words (``Wb`` for
    tight staging), the LPC's taps, and the tight buffer's capacity in words
    (0 when padded).  ``core`` maps the static input tensors to (packed,
    err, ns, wide); the decoder's config is bound in it."""

    def __init__(self, key: tuple, device: torch.device, core: Callable):
        rows, W, _, tight, flat_words = key
        self.key = key
        self.device = torch.device(device)
        self.core = core
        shapes = [(flat_words,), (rows,), (rows,)] if tight else [(rows, W), (rows,)]
        self.inputs = tuple(torch.zeros(s, dtype=torch.int32, device=self.device)
                            for s in shapes)
        self.uses = 0
        self.graph = None
        self.outputs = None
        #: Launches per kernel that one replay enqueues (recorded at capture).
        self.launches: dict[str, int] = {}
        self.capture_ms = None
        #: Bytes the card reserved for the graph's memory pool at capture (the
        #: rise of torch.cuda.memory_reserved: the pool takes new segments).
        self.pool_bytes = None
        self._done = None  # event after the last call's clones (CUDA)

    def run(self, host: tuple) -> tuple:
        """Fill the static inputs from ``host`` (`_host_stage`'s tuple), run
        the decode, and return fresh copies of (packed, err, ns, wide).  The
        caller holds the decoder's lock."""
        self.uses += 1
        if self.device.type != "cuda":
            self._fill(host)
            return tuple(t.clone() for t in self.core(*self.inputs))
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device)
            if self._done is not None:
                stream.wait_event(self._done)
            self._fill(host)
            if self.uses == 1:
                out = self.core(*self.inputs)
            else:
                if self.graph is None:
                    self._capture()
                self.graph.replay()
                for name, n in self.launches.items():
                    _build.count_launch(name, n)
                _build.count_launch("replay")
                out = self.outputs
            out = tuple(t.clone() for t in out)
            if self._done is None:
                self._done = torch.cuda.Event()
            self._done.record(stream)
        return out

    def _fill(self, host: tuple) -> None:
        # Non-blocking: a copy from pageable memory returns once CUDA has
        # staged the host bytes, without waiting for the stream's earlier
        # work, so the lock is held for the enqueue alone.
        for dst, src in zip(self.inputs, payload(host)):
            dst[: len(src)].copy_(torch.from_numpy(src), non_blocking=True)

    def _capture(self) -> None:
        """Capture the decode on the static inputs into a CUDA graph with a
        memory pool of its own, on a stream of its own.  Unlike
        `torch.cuda.graph`, no device synchronise, garbage collection or
        `empty_cache` first: a capture costs about one eager call.  Raises
        if the capture fails: nothing runs the decode another way."""
        before = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with _build.recording_launches() as launches, torch.cuda.stream(
                torch.cuda.Stream(self.device)):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = self.core(*self.inputs)
            finally:
                graph.capture_end()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - before
        self.graph, self.outputs, self.launches = graph, outputs, launches

    def release(self) -> None:
        """Drop the graph, its outputs and the static inputs, once the last
        call's clones are done (an evicted program's work may be in flight
        on another stream)."""
        if self._done is not None:
            self._done.synchronize()
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.outputs = self.inputs = None
