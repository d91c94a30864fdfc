"""Packet-level batch decode API on one PyTorch device.

Counterpart of saprobe_alac_tpu/decoder.py `BatchDecoder` (decoder.py:58-131).
Streams of C = 1..8 channels at 16, 20, 24 and 32 bits.  The batch runs on
the card unless the caller asks for the CPU: on a CUDA device through the
hand-written kernels, on ``"cpu"`` through their plain PyTorch versions.
"""

from __future__ import annotations

from typing import Sequence

from .config import PacketConfig
from .ops.batch import TorchBatchDecoder


class BatchDecoder:
    """Batched packet decoding for one PacketConfig on one device."""

    def __init__(self, config: PacketConfig, device="cuda"):
        self.config = config
        self.impl = TorchBatchDecoder(config, device)

    def decode_packets(self, packets: Sequence[bytes]) -> list[bytes]:
        """Decode a batch of packets; returns per-packet PCM byte strings."""
        if not packets:
            return []
        return self.impl.decode_packets(packets)

    def decode_async(self, packets: Sequence[bytes]):
        """Dispatch a batch without waiting for the device; pass the handle to
        :meth:`finish_async`."""
        if not packets:
            return ("sync", [])
        if self.impl._scalar_only:
            return ("sync", self.impl.decode_packets(packets))
        return ("device", self.impl.decode_async(packets))

    def finish_async(self, handle, packets: Sequence[bytes]) -> list[bytes]:
        """Materialize a :meth:`decode_async` handle into PCM byte strings."""
        kind, payload = handle
        if kind == "sync":
            return payload
        return self.impl.finish_async(payload, packets)
