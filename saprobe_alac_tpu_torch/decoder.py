"""Packet-level decode API.

Counterpart of saprobe_alac_tpu/decoder.py.  ``PacketDecoder`` is the
low-level single-packet surface (reference decoder.go:79-128:
NewPacketDecoder / DecodePacket / Format); ``BatchDecoder`` decodes
batches of packets that share one config.  Both take one backend word: a
CUDA device (``"cuda"``, the default) runs the hand-written kernels,
``"cpu"`` their plain PyTorch versions, ``"native"`` the repo's C++ core
on the host and ``"scalar"`` the Python oracle (codec/).  Streams of
C = 1..8 channels at 16, 20, 24 and 32 bits.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import native
from .codec import decode_packet as scalar_decode_packet
from .config import PacketConfig
from .errors import UnsupportedBitDepth
from .formats import ALAC_BIT_DEPTHS, PCMFormat
from .ops.batch import TorchBatchDecoder, _host_decode

#: The backends that decode on the host, packet by packet.
HOST_BACKENDS = ("native", "scalar")


def _format(config: PacketConfig) -> PCMFormat:
    if config.bit_depth not in ALAC_BIT_DEPTHS:
        raise UnsupportedBitDepth(f"unsupported bit depth {config.bit_depth}")
    return PCMFormat(config.sample_rate, config.bit_depth, config.num_channels)


class PacketDecoder:
    """Decodes single ALAC packets into interleaved LE signed PCM bytes.

    ``backend``: ``"cuda"`` (default; raises without a card) and ``"cpu"``
    decode each packet as a one-packet batch through `BatchDecoder`;
    ``"native"`` decodes it on the host by the C++ core, ``"scalar"`` by
    the Python oracle."""

    def __init__(self, config: PacketConfig, backend="cuda"):
        self._format = _format(config)
        self.config = config
        self.backend = backend
        self._batch = None if backend in HOST_BACKENDS else BatchDecoder(config, backend)

    def format(self) -> PCMFormat:
        return self._format

    def decode_packet(self, packet: bytes) -> bytes:
        """Decode one packet (a partial frame gives its own sample count);
        a malformed packet raises the oracle's class of the same name."""
        if self.backend == "scalar":
            return scalar_decode_packet(self.config, packet)[0]
        if self.backend == "native":
            return native.decode_packet(self.config, packet)
        return self._batch.decode_packets([packet])[0]


class BatchDecoder:
    """Batched packet decoding for one PacketConfig.

    ``device``: ``"cuda"`` (default; raises without a card), ``"cpu"``, any
    torch device, or a host backend: ``"native"`` (the C++ core) or
    ``"scalar"`` (the Python oracle).  With more than one card, ``"cuda"``
    shards each batch's packets over every card (`ShardedBatchDecoder`),
    as the JAX package does over its devices (decoder.py:83-96)."""

    def __init__(self, config: PacketConfig, device="cuda"):
        self._format = _format(config)
        self.config = config
        self.backend = device if device in HOST_BACKENDS else None
        if self.backend is not None:
            self.impl = None
        elif device == "cuda" and torch.cuda.device_count() > 1:
            from .parallel import ShardedBatchDecoder

            self.impl = ShardedBatchDecoder(config)
        else:
            self.impl = TorchBatchDecoder(config, device)

    def format(self) -> PCMFormat:
        return self._format

    @property
    def last_fallbacks(self) -> int:
        """Packets of the batch that finished last that the host path
        decoded (0 on a host backend)."""
        return self.impl.last_fallbacks if self.impl is not None else 0

    def decode_packets(self, packets: Sequence[bytes]) -> list[bytes]:
        """Decode a batch of packets; returns per-packet PCM byte strings."""
        if not packets:
            return []
        if self.backend == "scalar":
            return [scalar_decode_packet(self.config, p)[0] for p in packets]
        if self.backend == "native":
            return _host_decode(self.config, packets)
        return self.impl.decode_packets(packets)

    def decode_async(self, packets: Sequence[bytes]):
        """Dispatch a batch without waiting for the device; pass the handle to
        :meth:`finish_async`.  The host paths decode at once."""
        if not packets or self.impl is None or self.impl._scalar_only:
            return ("sync", self.decode_packets(packets))
        return ("device", self.impl.decode_async(packets))

    def finish_async(self, handle, packets: Sequence[bytes]) -> list[bytes]:
        """Materialize a :meth:`decode_async` handle into PCM byte strings."""
        kind, payload = handle
        if kind == "sync":
            return payload
        return self.impl.finish_async(payload, packets)
