"""Stereo un-decorrelation and PCM output formatting (NumPy-vectorized).

Behavioral parity with reference internal/alac/matrix.go (port of matrix_dec.c).
These stages are element-wise, so the oracle vectorizes them with NumPy using
explicit wrapping int32 arithmetic.

Un-decorrelation (matrix.go:38-49):
    left  = u + v - ((mixres * v) >> mixbits)     (wrapping int32)
    right = left - v
mixres == 0 means the channels are already independent.

Output formatting: interleaved little-endian signed PCM.  20-bit samples are
left-shifted by 4 into 3 bytes; 24/32-bit re-insert shift-buffer LSBs as
``(val << shift) | shiftbits`` when bytesShifted > 0.
"""

from __future__ import annotations

import numpy as np


def _wrap32(x: np.ndarray) -> np.ndarray:
    """Wrap int64 -> int32 (two's complement)."""
    return x.astype(np.int64).astype(np.uint64).astype(np.uint32).view(np.int32).astype(np.int64)


def unmix_stereo(u: np.ndarray, v: np.ndarray, mixbits: int, mixres: int) -> tuple[np.ndarray, np.ndarray]:
    """Un-decorrelate a channel pair; returns (left, right) as int64-valued int32s."""
    u = u.astype(np.int64)
    v = v.astype(np.int64)
    if mixres == 0:
        return u, v
    left = _wrap32(u + v - (_wrap32(mixres * v) >> mixbits))
    right = _wrap32(left - v)
    return left, right


def apply_shift(vals: np.ndarray, shift_bits: np.ndarray | None, bytes_shifted: int) -> np.ndarray:
    """Re-insert shift-buffer LSBs: (val << shift) | shiftbits (matrix.go:129-131)."""
    if bytes_shifted == 0 or shift_bits is None:
        return vals
    shift = bytes_shifted * 8
    return _wrap32((vals.astype(np.int64) << shift) | shift_bits.astype(np.int64))


def format_samples(vals: np.ndarray, bit_depth: int) -> np.ndarray:
    """Final per-sample value adjustment before byte packing (20-bit << 4)."""
    if bit_depth == 20:
        return _wrap32(vals.astype(np.int64) << 4)
    return vals


def pack_pcm(planes: np.ndarray, bit_depth: int) -> bytes:
    """Pack (num_samples, num_channels) int32-valued samples to interleaved LE bytes.

    16 -> 2 bytes, 20/24 -> 3 bytes, 32 -> 4 bytes per sample
    (matrix.go writers; byte order little-endian).
    """
    n, c = planes.shape
    vals = planes.astype(np.int64)
    if bit_depth == 16:
        return vals.astype(np.uint16).astype("<u2").tobytes()
    if bit_depth in (20, 24):
        u = vals.astype(np.uint32)
        out = np.empty((n, c, 3), dtype=np.uint8)
        out[..., 0] = u & 0xFF
        out[..., 1] = (u >> 8) & 0xFF
        out[..., 2] = (u >> 16) & 0xFF
        return out.tobytes()
    if bit_depth == 32:
        return vals.astype(np.uint32).astype("<u4").tobytes()
    raise ValueError(f"unsupported bit depth {bit_depth}")
