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
depth, pb, mb and kb, and (rows, width, taps, staging).  A key's first use
anywhere in the process runs eagerly, its second is captured as a CUDA
graph, and every later one, from any decoder, is one graph replay.

Staging is padded by default: the C++ core packs each packet, read in
place, into a row of the batch's bucketed width, in a staging buffer that
the decoder reuses (page-locked on a card, so the program's fill is an
asynchronous copy).  Each call in flight holds a buffer of its own from
submit to finish, as each holds a download buffer; the decoder counts
``staging_reuses`` and ``staging_allocs`` (`program.counts`).  The trim of
a large batch makes its ``bytes`` as it lets go of the decoder's previous
large batch's, so the memory a caller dropped is reused while its pages
are still mapped.
``tight=True`` uploads the packets back to back instead, each padded only
to its own word, with their word offsets, and builds the padded rows on the
device with one masked gather (batch.py:106-137, 273-302): fewer bytes over
the link, the same rows.

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
from .epilogue import extract_shift, finish_packed
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


def _byteswap(w: torch.Tensor) -> torch.Tensor:
    """Little- <-> big-endian int32 words, on their device (batch.py:66-75)."""
    return ((w >> 24) & 0xFF) | ((w >> 8) & 0xFF00) | ((w & 0xFF00) << 8) | (w << 24)


def _tight_rows(flat, starts, sizes, Wb):
    """The padded rows (B, Wb) from a tight buffer of little-endian words:
    swapped once to big-endian and gathered from each row's word offset,
    zero at and past ceil(size_bits / 32), so a row reads zeros past its
    packet as the padded rows' guard words give (batch.py:106-137)."""
    col = torch.arange(Wb, dtype=torch.int32, device=flat.device)
    words = _byteswap(flat)[starts[:, None] + col[None, :]]
    return torch.where(col[None, :] < ((sizes + 31) >> 5)[:, None], words, 0)


def _decode_core(words, sizes, *, F, C, depth, pb, mb, kb, taps, offsets):
    """The device part of a batch decode, from the staged rows (B, W) of
    big-endian words and their size_bits to (packed, err, ns, wide)
    (batch.py:140-243): the packet walk, the LPC at ``taps``, the shift
    region's reads at 24/32 bits, and the epilogue.  A pure function of
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
    # Only the 24/32-bit writers re-insert shift bits (epilogue.py); the
    # reader runs for every such batch, as in the JAX package's dense path.
    shift_vals = None
    if depth in (24, 32):
        shift_vals = extract_shift(words, w.shift_base, w.bs, w.role, w.ns, F=F, C=C)
    packed = finish_packed(
        mix, shift_vals, w.bs, w.mixbits, w.mixres, w.role, w.out_chan, w.filled,
        C=C, depth=depth,
    )
    return packed, w.err, w.ns, wide


def _decode_tight(flat, starts, sizes, *, Wb, **core):
    """`_decode_core` on the rows of a tight buffer (`_tight_rows`), as the
    JAX package's `_decode_batch_tight` wraps its core."""
    return _decode_core(_tight_rows(flat, starts, sizes, Wb), sizes, **core)


def payload(host: tuple) -> tuple:
    """The host arrays a call uploads, from `TorchBatchDecoder._host_stage`'s
    tuple: padded, (words (rows, W), size_bits), views of the staging
    buffer; tight, (the flat buffer's packet words, word offsets,
    size_bits).  The tight buffer's words past
    the last packet are not uploaded: a row is zero at and past its packet's
    last word (`_tight_rows`), and padding rows have size 0, so no row
    reads them and the stale words a longer earlier call left there are
    never seen."""
    if len(host) == 3:
        return host[:2]
    flat, starts, sizes, _ = host
    words = int(((sizes.astype(np.int64) + 31) >> 5).sum())
    return flat[:words], starts, sizes


def _program_key(host: tuple, taps: int) -> tuple:
    """A decode program's shape key from `_host_stage`'s tuple: (rows, W,
    taps, tight, flat words).  The tight buffer's capacity is the bucket of
    its size, so calls of one bucket share a program."""
    if len(host) == 3:
        words = host[0]
        return (words.shape[0], words.shape[1], taps, False, 0)
    flat, _, sizes, Wb = host
    return (sizes.shape[0], Wb, taps, True, _bucket(flat.size))


class _Handle(tuple):
    """A call's handle: the tuple, with the ``call`` id its spans share
    (None where no span was recorded) and the staging buffer its upload
    reads (None where it has none, or gave it back)."""

    call = None
    staging = None


def _staging(handle) -> torch.Tensor | None:
    """Take ``handle``'s staging buffer out of it (None where it has none):
    a handle finished twice gives its buffer back once."""
    buf = getattr(handle, "staging", None)
    if buf is not None:
        handle.staging = None
    return buf


def _tagged(handle, recorded):
    """``handle``, carrying ``recorded``'s call id where the span was
    recorded (a `_Handle`), else as it is."""
    if recorded.call is None:
        return handle
    out = _Handle(handle)
    out.call = recorded.call
    return out


def _decode_program(statics: tuple, shape: tuple):
    """``make`` of the decode program of ``statics`` (F, C, depth, pb, mb,
    kb) and ``shape`` (`_program_key`): its core, with the channel layout's
    offsets built on its device, and its static inputs."""
    F, C, depth, pb, mb, kb = statics
    rows, W, taps, tight, flat_words = shape

    def make(device):
        kw = dict(F=F, C=C, depth=depth, pb=pb, mb=mb, kb=kb, taps=taps,
                  offsets=channel_offsets(C, device))
        core = partial(_decode_tight, Wb=W, **kw) if tight else partial(_decode_core, **kw)
        shapes = [(flat_words,), (rows,), (rows,)] if tight else [(rows, W), (rows,)]
        return core, [(s, torch.int32) for s in shapes]

    return make


class TorchBatchDecoder:
    """Device-batched packet decoding for one PacketConfig on one device.

    ``tight``: stage the packets back to back and build the padded rows on
    the device (off by default, as in the JAX package); the bytes are the
    same either way."""

    def __init__(self, config: PacketConfig, device="cuda", tight: bool = False):
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
        self.tight = tight
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
        bucket of its size), in an ``alac.batch.pack`` span: padded, (words
        (rows, W) big-endian, size_bits), int32 tensors viewing one staging
        buffer from the pool, then that buffer (`_submit` hands it to the
        call's handle; a direct caller keeps it); tight, (flat little-endian
        words, int32 word offsets, size_bits, Wb), numpy arrays of their own."""
        with span(PACK) as p:
            rows = rows or _bucket(len(packets))
            lengths = native.packet_lengths(packets)
            width = _bucket((int(lengths.max(initial=0)) + 3) // 4 + native.GUARD_WORDS,
                            floor=16)
            if self.tight:
                return self._tight_stage(packets, lengths, rows, width)
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

    def _tight_stage(self, packets, lengths, rows, Wb) -> tuple:
        """`_host_stage`'s tight arrays: each packet padded to its own
        word, back to back (batch.py:273-302)."""
        sizes = np.zeros(rows, np.int32)
        sizes[: len(packets)] = lengths * 8
        wc = (lengths.astype(np.int64) + 3) // 4
        offs = np.zeros(rows, np.int64)
        np.cumsum(wc[:-1], out=offs[1 : len(packets)])
        # A row gathers Wb words from its offset: size the buffer past the
        # last packet's slice of Wb words, so no row reads beyond it.  (The
        # program's buffer is the bucket of this size, as the JAX package's,
        # but only the packets' words are uploaded: `payload`.)
        last = int(offs[len(packets) - 1]) if packets else 0
        flat = np.zeros(4 * max(int(wc.sum()) + native.GUARD_WORDS, last + Wb), np.uint8)
        for p, o in zip(packets, (4 * offs[: len(packets)]).tolist()):
            flat[o : o + len(p)] = np.frombuffer(p, np.uint8)
        return flat.view(np.int32), offs.astype(np.int32), sizes, Wb

    def _stage(self, packets: Sequence[bytes], rows: int | None = None):
        """Stage a batch on the device, outside any program: (words (rows,
        W), size_bits (rows,)), words big-endian as the walk reads them
        (tight staging: swapped and gathered on the device, `_tight_rows`)."""
        host = self._host_stage(packets, rows)
        if not self.tight:
            return host[0].to(self.device), host[1].to(self.device)
        up = [torch.from_numpy(a).to(self.device) for a in host[:3]]
        return _tight_rows(*up, host[3]), up[2]

    def _download(self, t: torch.Tensor) -> tuple[np.ndarray, torch.Tensor | None]:
        """Device -> host through a pinned buffer: on an H100 a pageable copy
        of a B=2048 F=4096 stereo batch (32 MiB) took 14 ms, a pinned one
        0.65 ms.  Returns (host view, its buffer); the view stays valid until
        the buffer goes back through `_release`.  Buffers are reused across
        calls, one to each call in flight, so threads may share a decoder."""
        if t.device.type == "cpu":
            return t.numpy(), None
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
            host = self._host_stage(packets, rows)
            shape = _program_key(host, taps)
            if s.recording:
                s.set(packets=len(packets), card=self._card, taps=taps, rows=shape[0],
                      width=shape[1])
            handle = _Handle(program.run(self.device, "decode", self.statics, shape,
                                         _decode_program(self.statics, shape), payload(host)))
        handle.call = s.call
        if len(host) == 3:
            handle.staging = host[2]
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
                    rows = np.ascontiguousarray(host[:n])
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
