"""Packet-axis data parallelism over several devices.

Counterpart of saprobe_alac_tpu/parallel/mesh.py.  ALAC packets are fully
self-contained (own headers, own coefficients, decoder state reset per
packet: reference decode.go:130-187), so scaling over cards is pure data
parallelism: the bucketed batch splits into equal contiguous shards, one a
device, and each shard runs the single-device pipeline of ops/batch.py on
its own device.  No collectives are needed (SURVEY §2.4); the shards' bytes
come back to the host and join in packet order.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..config import PacketConfig
from ..ops.batch import TorchBatchDecoder, _bucket
from ..utils.profiling import FINISH, SUBMIT, span


def make_packet_mesh(devices: Sequence | None = None) -> list[torch.device]:
    """The devices on the packet axis: ``devices`` as torch devices, or
    every card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        devices = range(torch.cuda.device_count())
        return [torch.device("cuda", i) for i in devices]
    return [torch.device(d) for d in devices]


class ShardedBatchDecoder:
    """Batch decoding sharded over several devices on the packet axis: one
    `TorchBatchDecoder` a device (its shards), and nothing of its own but
    the split and the join.

    A device may appear more than once: two shards on one card run one
    after the other there, through the one program of their key
    (ops/program.py).  A shard's device that fails raises: nothing
    moves to another device or to the host."""

    def __init__(self, config: PacketConfig, devices: Sequence | None = None):
        self.config = config
        self.devices = make_packet_mesh(devices)
        if not self.devices:
            raise ValueError("a sharded decoder needs at least one device")
        # One single-device pipeline a shard, each with its own pinned
        # staging and download buffers.
        self._shards = [TorchBatchDecoder(config, d) for d in self.devices]
        self._scalar_only = self._shards[0]._scalar_only  # the shards' rule
        #: Packets of the batch that finished last that the host path
        #: decoded, summed over the shards.
        self.last_fallbacks = 0

    def decode_packets(self, packets: Sequence[bytes]) -> list[bytes]:
        """Decode a batch to per-packet interleaved LE PCM bytes (a config
        the devices do not decode: on the host, through the first shard)."""
        if self._scalar_only:
            return self._shards[0].decode_packets(packets)
        return self.finish_async(self.decode_async(packets), packets)

    def decode_async(self, packets: Sequence[bytes], taps: int = 9):
        """Dispatch every shard before waiting on any; returns the shards'
        handles with their packets.  The bucket is rounded up to a multiple
        of the shard count (mesh.py:86-87), so every shard has the same
        rows.  A trailing shard that would hold only padding has nothing to
        decode and is not dispatched.  One ``alac.batch.submit`` span holds
        the shards' own; the handle carries its ``call`` id."""
        n = len(self._shards)
        rows = -(-max(_bucket(len(packets)), n) // n)
        parts = [packets[k * rows : (k + 1) * rows] for k in range(n)]
        with span(SUBMIT) as s:
            if s.recording:
                s.set(packets=len(packets), shards=n)
            handle = _Sharded(
                (shard.decode_async(part, taps=taps, rows=rows) if part else None, part)
                for shard, part in zip(self._shards, parts)
            )
        handle.call = s.call
        return handle

    def finish_async(self, handle, packets: Sequence[bytes]) -> list[bytes]:
        """Each shard's bytes in packet order (its error lanes on the host,
        its 32-tap retry on its own device); `last_fallbacks` is the sum.
        One ``alac.batch.finish`` span holds the shards' own."""
        out, fallbacks = [], 0
        with span(FINISH, handle.call) as s:
            if s.recording:
                s.set(packets=len(packets), shards=len(self._shards))
            for shard, (h, part) in zip(self._shards, handle):
                if part:
                    out += shard.finish_async(h, part)
                    fallbacks += shard.last_fallbacks
        self.last_fallbacks = fallbacks
        return out


class _Sharded(list):
    """A sharded call's handle: (shard handle or None, its packets) a
    shard, with the ``call`` id its spans share (None where no span was
    recorded)."""

    call = None
