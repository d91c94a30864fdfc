"""Batch decode orchestration: host packing -> device phases -> host bytes.

Counterpart of saprobe_alac_tpu/ops/batch.py `JaxBatchDecoder`: 16-, 20-,
24- and 32-bit streams of C = 1..8 channels in every element layout.  Every
batch takes the packet walk (one packet kernel launch for every element of
every packet, SCE+SCE stereo and DSE/FIL elements included).  A CUDA device
(the default) launches the kernels, the CPU runs their plain versions, and
nothing moves between the two by itself.  Packets that trip device-side
validation (any nonzero ERR_* code) are decoded by the exact host path, the
JAX package's error contract (batch.py:32-51, 380-390).
Staging and the host path run on the repo's C++ host core (``..native``); a
packet the core rejects raises the class the scalar oracle raises for it.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from .. import native
from ..config import PacketConfig
from ..errors import ConfigError, UnsupportedBitDepth, core_error
from .epilogue import extract_shift, finish_packed
from .lpc import lpc_batch
from .walk import ERR_NONE, walk_batch


def _host_decode(config: PacketConfig, packets: Sequence[bytes]) -> list[bytes]:
    """Host decode by the threaded C++ core.  The first packet the core
    rejects raises the error class of its code, the class the scalar oracle
    raises for the same packet (the JAX package re-runs the oracle to get
    it, batch.py:32-51)."""
    out, lens, errs = native.decode_batch(config, packets)
    bad = np.flatnonzero(errs)
    if bad.size:
        raise core_error(int(errs[bad[0]]))
    return [out[i, : lens[i]].tobytes() for i in range(len(packets))]


def _bucket(n: int, floor: int = 8) -> int:
    """Powers of two and midpoints: bounded shape variety, <= 33% padding."""
    b = floor
    while True:
        if n <= b:
            return b
        if n <= b + b // 2:
            return b + b // 2
        b *= 2


class TorchBatchDecoder:
    """Device-batched packet decoding for one PacketConfig on one device."""

    def __init__(self, config: PacketConfig, device="cuda"):
        if config.bit_depth not in (16, 20, 24, 32):
            raise UnsupportedBitDepth(f"unsupported bit depth {config.bit_depth}")
        if not 1 <= config.num_channels <= 8:
            raise ConfigError(f"unsupported channel count {config.num_channels}")
        self.device = torch.device(device)
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
        # Pinned download buffers not in use: each call in flight takes one
        # of its own, so threads that share a decoder never share a buffer.
        self._pinned_free: list[torch.Tensor] = []
        self._lock = threading.Lock()

    def _stage(self, packets: Sequence[bytes]):
        """Pack to bucketed shapes and upload: (words (B, W), size_bits (B,))
        on the device, words big-endian as the walk reads them."""
        longest = max(len(p) for p in packets)
        rows = _bucket(len(packets))
        width = _bucket((longest + 3) // 4 + native.GUARD_WORDS, floor=16)
        sizes = np.zeros(rows, np.int32)
        sizes[: len(packets)] = [len(p) * 8 for p in packets]
        words = native.pack_packets(packets, rows, width)
        return torch.from_numpy(words).to(self.device), torch.from_numpy(sizes).to(self.device)

    def _download(self, t: torch.Tensor) -> tuple[np.ndarray, torch.Tensor | None]:
        """Device -> host through a pinned buffer: on an H100 a pageable copy
        of a B=2048 F=4096 stereo batch (32 MiB) took 14 ms, a pinned one
        0.65 ms.  Returns (host view, its buffer); the view stays valid until
        the buffer goes back through `_release`.  Buffers are reused across
        calls, one to each call in flight, so threads may share a decoder."""
        if t.device.type == "cpu":
            return t.numpy(), None
        nbytes = t.numel() * t.element_size()
        with self._lock:
            buf = self._pinned_free.pop() if self._pinned_free else None
        if buf is None or buf.numel() < nbytes:  # a free buffer too small is dropped
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        view = buf[:nbytes].view(t.dtype).view(t.shape)
        view.copy_(t)
        return view.numpy(), buf

    def _release(self, buf: torch.Tensor | None) -> None:
        if buf is not None:
            with self._lock:
                self._pinned_free.append(buf)

    def decode_async(self, packets: Sequence[bytes], taps: int = 9):
        """Dispatch a batch; returns device tensors (packed, err, ns, wide)
        without waiting for the device.  ``taps=9`` serves orders up to 8;
        finish_async re-runs at 32 taps when ``wide`` flags an order 9..30."""
        cfg = self.config
        words, sizes = self._stage(packets)
        F, C, depth = cfg.frame_length, cfg.num_channels, cfg.bit_depth
        w = walk_batch(words, sizes, F=F, C=C, depth=depth, pb=cfg.pb, mb=cfg.mb, kb=cfg.kb)
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

    def _to_bytes(self, packed_row: np.ndarray, ns: int) -> bytes:
        """One packet's PCM from its finish_packed row (batch.py:348-364)."""
        depth, C = self.config.bit_depth, self.config.num_channels
        if depth == 16:
            # Even channel counts: int32 words of two LE int16 samples each;
            # odd ones: int16 samples.
            return packed_row[: ns * C // 2 if C % 2 == 0 else ns * C].tobytes()
        if depth in (20, 24):
            nb = ns * C * 3
            if (self.config.frame_length * C) % 4 == 0:
                # Four 3-byte samples per three LE int32 words; trim to bytes.
                return packed_row[: (nb + 3) // 4].tobytes()[:nb]
            return packed_row[:nb].tobytes()
        return packed_row[: ns * C].tobytes()

    def finish_async(self, handle, packets: Sequence[bytes]) -> list[bytes]:
        """Materialize a decode_async result into per-packet PCM bytes."""
        packed, err, ns, wide = handle
        if bool(wide[: len(packets)].any()):
            packed, err, ns, _ = self.decode_async(packets, taps=32)
        err = err.cpu().numpy()
        ns = ns.cpu().numpy()
        fb_idx = [i for i in range(len(packets)) if err[i] != ERR_NONE]
        fb = {}
        if fb_idx:
            fb = dict(zip(fb_idx, _host_decode(self.config, [packets[i] for i in fb_idx])))
        host, buf = self._download(packed)
        try:
            out = [
                fb[i] if i in fb else self._to_bytes(host[i], int(ns[i]))
                for i in range(len(packets))
            ]
        finally:
            self._release(buf)
        with self._lock:
            self.last_fallbacks = len(fb_idx)
        return out

    def decode_packets(self, packets: Sequence[bytes]) -> list[bytes]:
        """Decode a batch to per-packet interleaved LE PCM bytes.  Raises the
        oracle's exception for malformed packets."""
        if self._scalar_only:
            return _host_decode(self.config, packets)
        return self.finish_async(self.decode_async(packets), packets)
