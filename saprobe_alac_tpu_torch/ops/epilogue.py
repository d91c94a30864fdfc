"""Phase 3: stereo unmix, channel remap and 16-bit PCM packing (PyTorch).

Counterpart of saprobe_alac_tpu/ops/epilogue.py `_finish_planes`, `finish`,
`pack_output` and `finish_packed` for 16-bit streams with C <= 2.  Plain
PyTorch: the JAX package computes these in XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from .torchint import sshr, wrap


def _finish_planes(mix, mixbits, mixres, role, out_chan, filled, C):
    """mix: (F, C*B) channel-major lanes.  Returns the C SMPTE-ordered (F, B)
    output planes (int64 holding int32 values)."""
    B = mix.shape[1] // C
    chans = [mix[:, c * B:(c + 1) * B].to(torch.int64) for c in range(C)]
    # Stereo un-decorrelation (matrix.go:38-49), wrapping int32:
    #   left = u + v - ((mixres*v) >> mixbits); right = left - v
    for c in range(C - 1):
        is_u = (role[:, c] == 1)[None, :]
        uv, vv = chans[c], chans[c + 1]
        mres = mixres[:, c][None, :].to(torch.int64)
        corr = sshr(wrap(mres * vv), mixbits[:, c][None, :])
        mixed = is_u & (mres != 0)
        left = torch.where(mixed, wrap(uv + vv - corr), uv)
        right = torch.where(mixed, wrap(left - vv), vv)
        chans[c] = torch.where(is_u, left, chans[c])
        chans[c + 1] = torch.where(is_u, right, chans[c + 1])
    # MPEG -> SMPTE remap by select; slots no element decoded into stay 0.
    planes = []
    for c_out in range(C):
        acc = torch.zeros_like(chans[0])
        for c in range(C):
            sel = ((filled[:, c] != 0) & (out_chan[:, c] == c_out))[None, :]
            acc = torch.where(sel, chans[c], acc)
        planes.append(acc)
    return planes


def finish(mix, mixbits, mixres, role, out_chan, filled, *, C):
    """(B, F, C) int32 output samples in SMPTE order."""
    planes = _finish_planes(mix, mixbits, mixres, role, out_chan, filled, C)
    return torch.stack(planes, dim=-1).transpose(0, 1).to(torch.int32)


def pack_output(out):
    """16-bit interleaved PCM: (B, F, C) -> (B, F*C) int16."""
    B, F, C = out.shape
    return out.reshape(B, F * C).to(torch.int16)


def finish_packed(mix, mixbits, mixres, role, out_chan, filled, *, C):
    """finish() + pack_output() with the 16-bit stereo interleave fused: the
    (left, right) pair of frame f packs into one int32 word whose
    little-endian bytes are the two little-endian int16 samples
    (matrix.go:30-63).  Mono returns (B, F) int16."""
    if C == 1:
        return pack_output(finish(mix, mixbits, mixres, role, out_chan, filled, C=1))
    if C != 2:
        raise NotImplementedError(f"16-bit packing for C={C} is not ported")
    left, right = _finish_planes(mix, mixbits, mixres, role, out_chan, filled, C)
    packed = wrap((left & 0xFFFF) | ((right & 0xFFFF) << 16))
    return packed.T.contiguous().to(torch.int32)
