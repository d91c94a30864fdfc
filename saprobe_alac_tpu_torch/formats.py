"""PCM format descriptors (the port's copy of saprobe_alac_tpu/formats.py;
reference format.go:20-24, internal/alac/format.go:23-34)."""

from __future__ import annotations

from dataclasses import dataclass

from .errors import UnsupportedBitDepth

#: Bit depths ALAC supports (reference decoder.go:28-33).
ALAC_BIT_DEPTHS = (16, 20, 24, 32)


@dataclass(frozen=True)
class PCMFormat:
    """Format of decoded PCM audio output (interleaved little-endian signed)."""

    sample_rate: int
    bit_depth: int
    channels: int


def bytes_per_sample(depth: int) -> int:
    """Bytes used to store one sample: 16 -> 2, 20/24 -> 3, 32 -> 4."""
    if depth == 16:
        return 2
    if depth in (20, 24):
        return 3
    if depth == 32:
        return 4
    raise UnsupportedBitDepth(f"unsupported bit depth {depth}")
