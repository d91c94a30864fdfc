"""Interleaved little-endian PCM bytes <-> (n, channels) integer arrays
(the port's copy of saprobe_alac_tpu/utils/pcmconv.py)."""

from __future__ import annotations

import numpy as np

from ..formats import PCMFormat, bytes_per_sample


def pcm_bytes_to_array(fmt: PCMFormat, data: bytes) -> np.ndarray:
    """Decode interleaved little-endian signed PCM bytes to (n, ch) int64."""
    c = fmt.channels
    bps = bytes_per_sample(fmt.bit_depth)
    n = len(data) // (c * bps)
    data = data[: n * c * bps]
    if fmt.bit_depth == 16:
        return np.frombuffer(data, dtype="<i2").reshape(n, c).astype(np.int64)
    if fmt.bit_depth == 32:
        return np.frombuffer(data, dtype="<i4").reshape(n, c).astype(np.int64)
    # 3-byte samples (20-bit values travel << 4 in a 24-bit container).
    raw = np.frombuffer(data, dtype=np.uint8).reshape(n, c, 3).astype(np.int64)
    vals = raw[..., 0] | (raw[..., 1] << 8) | (raw[..., 2] << 16)
    vals = (vals << 40) >> 40  # sign-extend 24 bits
    if fmt.bit_depth == 20:
        vals >>= 4
    return vals


def array_to_pcm_bytes(fmt: PCMFormat, samples: np.ndarray) -> bytes:
    """Inverse of pcm_bytes_to_array: the decoder's output layout (2-byte
    samples at 16 bits, 3-byte at 20 (<< 4) and 24, 4-byte at 32)."""
    vals = samples.astype(np.int64)
    bps = bytes_per_sample(fmt.bit_depth)
    if fmt.bit_depth == 20:
        vals = vals << 4
    if bps == 2:
        return vals.astype("<u2").tobytes()
    words = vals.astype("<u4")
    if bps == 4:
        return words.tobytes()
    return words.view(np.uint8).reshape(*vals.shape, 4)[..., :3].tobytes()
