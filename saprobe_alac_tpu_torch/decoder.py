"""Packet-level decode API.

Counterpart of saprobe_alac_tpu/decoder.py.  ``PacketDecoder`` is the
low-level single-packet surface (reference decoder.go:79-128:
NewPacketDecoder / DecodePacket / Format); ``BatchDecoder`` decodes
batches of packets that share one config.  Both take one backend word: a
CUDA device (``"cuda"``, the default) runs the hand-written kernels,
``"cpu"`` their plain PyTorch versions, and ``"native"`` the repo's C++
core on the host.  Streams of C = 1..8 channels at 16, 20, 24 and 32 bits.
"""

from __future__ import annotations

from typing import Sequence

from . import native
from .config import PacketConfig
from .errors import UnsupportedBitDepth
from .formats import ALAC_BIT_DEPTHS, PCMFormat
from .ops.batch import TorchBatchDecoder, _host_decode


def _no_scalar(backend) -> None:
    if backend == "scalar":
        raise ValueError(
            "backend 'scalar' needs the Python oracle (saprobe_alac_tpu/codec/), which the "
            "port does not have yet; use 'native'"
        )


def _format(config: PacketConfig) -> PCMFormat:
    if config.bit_depth not in ALAC_BIT_DEPTHS:
        raise UnsupportedBitDepth(f"unsupported bit depth {config.bit_depth}")
    return PCMFormat(config.sample_rate, config.bit_depth, config.num_channels)


class PacketDecoder:
    """Decodes single ALAC packets into interleaved LE signed PCM bytes.

    ``backend``: ``"cuda"`` (default; raises without a card) and ``"cpu"``
    decode each packet as a one-packet batch through `BatchDecoder`;
    ``"native"`` decodes it on the host by the C++ core."""

    def __init__(self, config: PacketConfig, backend="cuda"):
        _no_scalar(backend)
        self._format = _format(config)
        self.config = config
        self._batch = None if backend == "native" else BatchDecoder(config, backend)

    def format(self) -> PCMFormat:
        return self._format

    def decode_packet(self, packet: bytes) -> bytes:
        """Decode one packet (a partial frame gives its own sample count);
        a malformed packet raises the oracle's class of the same name."""
        if self._batch is None:
            return native.decode_packet(self.config, packet)
        return self._batch.decode_packets([packet])[0]


class BatchDecoder:
    """Batched packet decoding for one PacketConfig.

    ``device``: ``"cuda"`` (default; raises without a card), ``"cpu"``, any
    torch device, or ``"native"`` for the host C++ core."""

    def __init__(self, config: PacketConfig, device="cuda"):
        _no_scalar(device)
        self._format = _format(config)
        self.config = config
        self.impl = None if device == "native" else TorchBatchDecoder(config, device)

    def format(self) -> PCMFormat:
        return self._format

    def decode_packets(self, packets: Sequence[bytes]) -> list[bytes]:
        """Decode a batch of packets; returns per-packet PCM byte strings."""
        if not packets:
            return []
        if self.impl is None:
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
