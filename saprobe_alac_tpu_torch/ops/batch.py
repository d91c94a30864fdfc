"""Batch decode orchestration: host packing -> device program -> host bytes.

Counterpart of saprobe_alac_tpu/ops/batch.py `JaxBatchDecoder`: 16-, 20-,
24- and 32-bit streams of C = 1..8 channels in every element layout.  Every
batch takes the packet walk (one packet kernel launch for every element of
every packet, SCE+SCE stereo and DSE/FIL elements included).  A CUDA device
(the default) launches the kernels, the CPU runs their plain versions, and
nothing moves between the two by itself.  Packets that trip device-side
validation (any nonzero ERR_* code) are decoded by the exact host path, the
JAX package's error contract (batch.py:32-51, 380-390): the repo's C++ host
core (``..native``), and the scalar oracle (``..codec``) for a packet the
core rejects, so it raises the oracle's typed exception.

As the JAX package compiles one executable per (config statics, batch
bucket, width bucket, taps) and every decoder of the process reuses it
(batch.py:78-138), the device part of a call, `_decode_core`, runs through
the process-wide program of its key (ops/program.py): the config's F, C,
depth, pb, mb and kb, and (rows, width, taps).  A key's first use
anywhere in the process runs eagerly, its second is captured as a CUDA
graph, and every later one, from any decoder, is one graph replay.

Staging: the C++ core packs each packet, read in place, into a row of the
batch's bucketed width, in a staging buffer that the decoder reuses
(page-locked on a card, so the program's fill is an asynchronous copy).
Each call in flight holds a buffer of its own from submit to finish, as
each holds a download buffer; the decoder counts
``staging_reuses`` and ``staging_allocs`` (`program.counts`).  The trim of
a large batch makes its ``bytes`` as it lets go of the decoder's previous
large batch's, so the memory a caller dropped is reused while its pages
are still mapped.

While a torch.profiler session records, a call records its host stages as
spans (utils/profiling.py): ``alac.batch.submit`` around `decode_async`,
holding ``alac.batch.pack`` (`_host_stage`; attribute ``reused``: the
padded rows went into a pooled buffer) and the program's
``alac.program.dispatch`` and ``alac.program.fill``; ``alac.batch.finish``
around `finish_async`, holding ``alac.batch.download`` (the readbacks and
the pinned copy; the 32-tap retry's submit inside it),
``alac.batch.fallback`` (error lanes on the host) and ``alac.batch.trim``
(the ``bytes``: from `NATIVE_TRIM_BYTES` in all one threaded call into the
C++ core, `native.rows_to_bytes`, else `_to_bytes` a row; attributes
``packets``, ``bytes`` and ``threads``).  Every span of a call
shares its ``call`` id: the handle carries it from the submit to the
finish.  The card's counters (`program.counts`) count ``calls``,
``packets``, ``fallback_packets``, ``wide_retries`` and ``trim_bytes`` (the
bytes the trim copied) whether or not a profiler records.
"""

from __future__ import annotations

import threading
from functools import partial
from typing import Sequence

import numpy as np
import torch

from .. import native
from ..codec import decode_packet as scalar_decode_packet
from ..config import PacketConfig
from ..errors import ConfigError, UnsupportedBitDepth
from ..utils.profiling import DOWNLOAD, FALLBACK, FINISH, PACK, SUBMIT, TRIM, span
from . import program
from .epilogue import epilogue
from .lpc import lpc_batch
from .walk import ERR_NONE, channel_offsets, walk_batch


def _host_decode(config: PacketConfig, packets: Sequence[bytes]) -> list[bytes]:
    """Host decode by the threaded C++ core.  A packet the core rejects is
    re-run through the scalar oracle, so it raises the oracle's typed
    exception (or gives the oracle's bytes where the oracle accepts it), as
    the JAX package does (batch.py:32-51)."""
    out, lens, errs = native.decode_batch(config, packets)
    return [
        scalar_decode_packet(config, p)[0] if errs[i] else out[i, : lens[i]].tobytes()
        for i, p in enumerate(packets)
    ]


#: From this many PCM bytes in a batch, `finish_async` trims in one call
#: into the C++ core on OpenMP's threads (`native.rows_to_bytes`); below it,
#: one row at a time here (`_to_bytes`), which costs no more at that size
#: and pays no fork and join.  Chosen from a curve of both on an H100's
#: 8-core host (PERF.md §6).
NATIVE_TRIM_BYTES = 1 << 19


def _bucket(n: int, floor: int = 8) -> int:
    """Powers of two and midpoints: bounded shape variety, <= 33% padding."""
    b = floor
    while True:
        if n <= b:
            return b
        if n <= b + b // 2:
            return b + b // 2
        b *= 2


def _decode_core(words, sizes, *, F, C, depth, pb, mb, kb, taps, offsets):
    """The device part of a batch decode, from the staged rows (B, W) of
    big-endian words and their size_bits to (packed, err, ns, wide)
    (batch.py:140-243): the packet walk, the LPC at ``taps``, the shift
    region's reads at 24/32 bits, and the epilogue (on a card one launch of
    the epilogue kernel, `epilogue.epilogue`).  A pure function of
    device tensors whose shapes the program key fixes: no host sync and no
    host-to-device copy, so a CUDA graph can capture it.  ``offsets``:
    `walk.channel_offsets(C)` on the batch's device."""
    w = walk_batch(words, sizes, F=F, C=C, depth=depth, pb=pb, mb=mb, kb=kb, offsets=offsets)
    L = words.shape[0] * C
    mix = lpc_batch(
        w.res,
        w.order.T.reshape(L),
        w.mode.T.reshape(L),
        w.den.T.reshape(L),
        w.cb.T.reshape(L),
        w.ns.repeat(C),
        w.coefs.transpose(0, 1).reshape(L, 32),
        F=F,
        taps=taps,
    )
    if taps == 9:
        wide = ((w.order >= 9) & (w.order <= 30)).any(dim=1)
    else:
        wide = torch.zeros_like(w.err, dtype=torch.bool)
    # Only the 24/32-bit writers re-insert shift bits; the raw reader runs
    # for every such batch, as in the JAX package's dense path.
    packed = epilogue(words, mix, w, F=F, C=C, depth=depth)
    return packed, w.err, w.ns, wide


class _Handle(tuple):
    """A call's handle: the tuple, with the ``call`` id its spans share
    (None where no span was recorded) and the staging buffer its upload
    reads (None once given back)."""

    call = None
    staging = None


def _staging(handle) -> torch.Tensor | None:
    """Take ``handle``'s staging buffer out of it (None where it has none):
    a handle finished twice gives its buffer back once."""
    buf = getattr(handle, "staging", None)
    if buf is not None:
        handle.staging = None
    return buf


def _decode_program(statics: tuple, shape: tuple):
    """``make`` of the decode program of ``statics`` (F, C, depth, pb, mb,
    kb) and ``shape`` (rows, W, taps): its core, with the channel layout's
    offsets built on its device, and its static inputs."""
    F, C, depth, pb, mb, kb = statics
    rows, W, taps = shape

    def make(device):
        core = partial(_decode_core, F=F, C=C, depth=depth, pb=pb, mb=mb, kb=kb, taps=taps,
                       offsets=channel_offsets(C, device))
        return core, [((rows, W), torch.int32), ((rows,), torch.int32)]

    return make


class TorchBatchDecoder:
    """Device-batched packet decoding for one PacketConfig on one device."""

    def __init__(self, config: PacketConfig, device="cuda"):
        if config.bit_depth not in (16, 20, 24, 32):
            raise UnsupportedBitDepth(f"unsupported bit depth {config.bit_depth}")
        if not 1 <= config.num_channels <= 8:
            raise ConfigError(f"unsupported channel count {config.num_channels}")
        self.device = torch.device(device)
        self._card = str(self.device)  # the spans' ``card``
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self.config = config
        # kb == 0 relies on Go uint32 bit-position wrap, and absurd frame
        # lengths would blow device memory: such streams go to the host.
        self._scalar_only = config.kb == 0 or not 1 <= config.frame_length <= (1 << 16)
        #: Packets of the batch that finished last that the host path decoded.
        self.last_fallbacks = 0
        # Download and staging buffers not in use (pinned on a card): each
        # call in flight takes one of each of its own, so threads that share
        # a decoder never share a buffer.  A staging buffer comes back only
        # after the download has waited for the call's upload; one whose
        # handle is dropped unfinished is freed, and PyTorch's pinned
        # allocator keeps it until the copies it recorded are done.
        self._pinned_free: list[torch.Tensor] = []
        self._staging_free: list[torch.Tensor] = []
        # The last large trim's outputs, held until the next large trim
        # makes its own in their memory (`native.rows_to_bytes`): a caller
        # that drops each batch's bytes then finds its next batch's pages
        # already faulted in.  At most one batch's PCM a decoder.
        self._spare: list[bytes] = []
        # Guards the free lists, the spare outputs and last_fallbacks; never
        # held while a program runs.
        self._lock = threading.Lock()
        #: The decode programs' static arguments: the config's fields that
        #: shape the device code (as the JAX jit's static arguments).
        self.statics = (config.frame_length, config.num_channels, config.bit_depth, config.pb,
                        config.mb, config.kb)
        # Bytes of one sample of every channel in the PCM a packet returns.
        self._frame_bytes = config.num_channels * native.BYTES_PER_SAMPLE[config.bit_depth]

    def _host_stage(self, packets: Sequence[bytes], rows: int | None = None) -> tuple:
        """The host arrays a batch uploads, ``rows`` rows (by default the
        bucket of its size), in an ``alac.batch.pack`` span: (words (rows, W)
        big-endian, size_bits), int32 tensors viewing one staging buffer
        from the pool, then that buffer (`_submit` hands it to the call's
        handle; a direct caller keeps it)."""
        with span(PACK) as p:
            rows = rows or _bucket(len(packets))
            lengths = native.packet_lengths(packets)
            width = _bucket((int(lengths.max(initial=0)) + 3) // 4 + native.GUARD_WORDS,
                            floor=16)
            words = rows * width
            buf, reused = self._take(self._staging_free, 4 * (words + rows))
            program.add_counts(self.device, staging_reuses=int(reused),
                               staging_allocs=int(not reused))
            if p.recording:
                p.set(reused=reused)
            # Tensor views, not numpy ones: a copy from them records its
            # stream with the pinned allocator (see `__init__`).
            packed = buf[: 4 * words].view(torch.int32).view(rows, width)
            sizes = buf[4 * words : 4 * (words + rows)].view(torch.int32)
            native.pack_rows(packets, lengths, packed.numpy())
            bits = sizes.numpy()
            np.multiply(lengths, 8, out=bits[: len(packets)])
            bits[len(packets) :] = 0
            return packed, sizes, buf

    def _stage(self, packets: Sequence[bytes], rows: int | None = None):
        """Stage a batch on the device, outside any program: (words (rows,
        W), size_bits (rows,)), words big-endian as the walk reads them."""
        words, sizes, _ = self._host_stage(packets, rows)
        return words.to(self.device), sizes.to(self.device)

    def _download(self, t: torch.Tensor) -> tuple[np.ndarray, torch.Tensor | None]:
        """Device -> host through a pinned buffer: on an H100 a pageable copy
        of a B=2048 F=4096 stereo batch (32 MiB) took 14 ms, a pinned one
        0.65 ms.  Returns (C-contiguous host view, its buffer); the view
        stays valid until the buffer goes back through `_give`.  Buffers are
        reused across calls, one to each call in flight, so threads may
        share a decoder."""
        if t.device.type == "cpu":
            return t.contiguous().numpy(), None
        nbytes = t.numel() * t.element_size()
        buf, _ = self._take(self._pinned_free, nbytes)
        view = buf[:nbytes].view(t.dtype).view(t.shape)
        view.copy_(t)
        return view.numpy(), buf

    def _take(self, free: list, nbytes: int) -> tuple[torch.Tensor, bool]:
        """A host buffer of at least ``nbytes`` bytes from the free list
        ``free``, and True; else a new one (pinned on a card), and False.
        A free buffer too small is dropped."""
        with self._lock:
            buf = free.pop() if free else None
        if buf is not None and buf.numel() >= nbytes:
            return buf, True
        return torch.empty(nbytes, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda"), False

    def _give(self, free: list, buf: torch.Tensor | None) -> None:
        """Put ``buf`` (if any) back on the free list ``free``."""
        if buf is not None:
            with self._lock:
                free.append(buf)

    def decode_async(self, packets: Sequence[bytes], taps: int = 9, rows: int | None = None):
        """Dispatch a batch through its key's process-wide program; returns
        device tensors (packed, err, ns, wide) of its own, without waiting
        for the device.
        ``taps=9`` serves orders up to 8; finish_async re-runs at 32 taps
        when ``wide`` flags an order 9..30, staged as the first run was.
        ``rows``: the batch's rows (by default the bucket of its size)."""
        program.add_counts(self.device, calls=1, packets=len(packets))
        return self._submit(packets, taps, rows)

    def _submit(self, packets: Sequence[bytes], taps: int, rows: int | None):
        """Stage a batch and run its key's program (``alac.batch.submit``)."""
        with span(SUBMIT) as s:
            words, sizes, staging = self._host_stage(packets, rows)
            shape = (*words.shape, taps)
            if s.recording:
                s.set(packets=len(packets), card=self._card, taps=taps, rows=shape[0],
                      width=shape[1])
            handle = _Handle(program.run(self.device, "decode", self.statics, shape,
                                         _decode_program(self.statics, shape), (words, sizes)))
        handle.call, handle.staging = s.call, staging
        return handle

    def _to_bytes(self, packed_row: np.ndarray, ns: int) -> bytes:
        """One packet's PCM: the first ns * C * bytes-a-sample bytes of its
        contiguous finish_packed row, in every layout (batch.py:348-364)."""
        return packed_row.view(np.uint8)[: ns * self._frame_bytes].tobytes()

    def finish_async(self, handle, packets: Sequence[bytes]) -> list[bytes]:
        """Materialize a decode_async result into per-packet PCM bytes."""
        n = len(packets)
        with span(FINISH, getattr(handle, "call", None)) as s:
            if s.recording:
                s.set(packets=n, card=self._card)
            packed, err, ns, wide = handle
            staged = [_staging(handle)]
            with span(DOWNLOAD):
                if bool(wide[:n].any()):
                    program.add_counts(self.device, wide_retries=1)
                    retry = self._submit(packets, 32, err.shape[0])
                    packed, err, ns, _ = retry
                    staged.append(_staging(retry))
                err = err.cpu().numpy()
                ns = ns.cpu().numpy()
                host, buf = self._download(packed)
            try:
                fb_idx = np.flatnonzero(err[:n] != ERR_NONE).tolist()
                fb = []
                if fb_idx:
                    program.add_counts(self.device, fallback_packets=len(fb_idx))
                    with span(FALLBACK, packets=len(fb_idx)):
                        fb = _host_decode(self.config, [packets[i] for i in fb_idx])
                with span(TRIM) as t:
                    rows = host[:n]
                    lengths = ns[:n].astype(np.int64) * self._frame_bytes
                    lengths[fb_idx] = 0
                    trimmed = int(lengths.sum())
                    if trimmed >= NATIVE_TRIM_BYTES:
                        with self._lock:
                            spare, self._spare = self._spare, []
                        out, threads = native.rows_to_bytes(rows, lengths, spare)
                        with self._lock:
                            self._spare = list(out)
                    else:
                        out = [self._to_bytes(rows[i], int(ns[i])) if k else b""
                               for i, k in enumerate(lengths.tolist())]
                        threads = 1
                    for i, pcm in zip(fb_idx, fb):
                        out[i] = pcm
                    if t.recording:
                        t.set(packets=n - len(fb_idx), bytes=trimmed, threads=threads)
            finally:
                # The download waited for every earlier operation on the
                # stream, the uploads from the staging buffers among them.
                self._give(self._pinned_free, buf)
                for b in staged:
                    self._give(self._staging_free, b)
        program.add_counts(self.device, trim_bytes=trimmed)
        with self._lock:
            self.last_fallbacks = len(fb_idx)
        return out

    def decode_packets(self, packets: Sequence[bytes]) -> list[bytes]:
        """Decode a batch to per-packet interleaved LE PCM bytes.  Raises the
        oracle's exception for malformed packets."""
        if self._scalar_only:
            return _host_decode(self.config, packets)
        return self.finish_async(self.decode_async(packets), packets)
