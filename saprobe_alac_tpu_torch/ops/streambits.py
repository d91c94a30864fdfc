"""Bit-stream reads over packed (B, W) big-endian word batches (PyTorch).

Counterpart of saprobe_alac_tpu/ops/streambits.py.  Each row holds one
packet; reads take per-lane bit positions.  Words outside [0, W) read as
zero, the reference BitBuffer's zero padding (bitbuffer.go:28-32); the
packer's guard words (bitpack.GUARD_WORDS) make the upper edge agree with the
JAX package's clamped reads.
"""

from __future__ import annotations

import torch

from .torchint import u, ushr, wrap


def gather_word(words: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """words (B, W) int32, wi (B,) or (B, K) word indices -> int64 unsigned
    words of wi's shape; zero where wi lies outside the row."""
    W = words.shape[1]
    inside = (wi >= 0) & (wi < W)
    idx = wi.clamp(0, W - 1).to(torch.int64)
    if idx.ndim == 1:
        got = torch.gather(words, 1, idx[:, None])[:, 0]
    else:
        got = torch.gather(words, 1, idx)
    return torch.where(inside, u(got), 0)


def window32(words: torch.Tensor, bitpos: torch.Tensor) -> torch.Tensor:
    """The 32 stream bits starting at ``bitpos`` (int64 holding the int32
    pattern)."""
    bitpos = bitpos.to(torch.int64)
    wi = bitpos >> 5
    r = bitpos & 31
    w0 = gather_word(words, wi)
    w1 = gather_word(words, wi + 1)
    win = ((w0 << r) & 0xFFFFFFFF) | ((w1 >> 1) >> (31 - r))
    return wrap(win)


def vread(words: torch.Tensor, bitpos: torch.Tensor, n) -> torch.Tensor:
    """Right-aligned read of n (1..32) bits at per-lane bit positions (int64
    holding the int32 value; n may be an int or per-lane)."""
    return ushr(window32(words, bitpos), 32 - n)
