"""Stream configuration: the fields of the ALAC magic cookie.

Same fields as saprobe_alac_tpu/config.py `PacketConfig` (ALACSpecificConfig,
reference config.go:27-38); the port reads them by name, so either class
configures it.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PacketConfig:
    frame_length: int
    bit_depth: int
    num_channels: int
    pb: int
    mb: int
    kb: int
    max_run: int
    max_frame_bytes: int
    avg_bit_rate: int
    sample_rate: int
