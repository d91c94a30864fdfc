"""Phase 3: shift region, stereo unmix, channel remap and PCM packing.

Counterpart of saprobe_alac_tpu/ops/epilogue.py `extract_shift_kernel`,
`_finish_planes`, `pack_output` and `finish_packed` for C = 1..8 at
every depth (16, 20, 24, 32).  Plain PyTorch around the raw reader: the JAX
package computes these in XLA outside any Pallas kernel.  Values are int64
tensors holding int32 patterns; every sum and shift that can leave the int32
range is wrapped (torchint).
"""

from __future__ import annotations

import torch

from .raw_reader import raw_read
from .torchint import shl, sshr, ushr, wrap


def shift_reads(shift_base, bs, role, ns, c=0):
    """The raw reader's lane inputs (base, step, width, act, n) for the shift
    region of channel ``c``, contiguous int32.

    Mono channels read consecutive ``bs*8``-bit values; a CPE interleaves
    U/V (decoder.go:314-321, 492-502), so the U channel reads each
    ``(u << w) | v`` pair as ONE 2w-bit field and the V channel (role 2)
    reads nothing of its own: it takes the low half of its partner's read."""
    width = bs[:, c] * 8
    stride = torch.where(role[:, c] == 0, width, 2 * width)
    act = (bs[:, c] > 0) & (role[:, c] != 2)
    lanes = (shift_base[:, c], stride, stride, act, ns)
    return tuple(x.to(torch.int32).contiguous() for x in lanes)


def extract_shift(words, shift_base, bs, role, ns, *, F, C):
    """The shift region's low bits: (F, C, B) int32 F-major planes, equal to
    the JAX package's `extract_shift_kernel` (epilogue.py:109-142): one read
    per channel with `shift_reads` (C launches, a channel that no lane reads
    for included, as there), the V halves split from channel c - 1's fused
    read."""
    # Shift bits are OR-ed back in unsigned.
    reads = [
        raw_read(words, *shift_reads(shift_base, bs, role, ns, c), F=F, signed=False)[:F]
        .to(torch.int64)
        for c in range(C)
    ]
    planes = []
    for c in range(C):
        width = bs[:, c] * 8
        # U lanes: high half of the fused read; mono lanes: the value itself.
        val = torch.where(role[:, c] == 1, ushr(reads[c], width), reads[c])
        if c > 0:
            # V lanes: low half of the partner channel's fused read.
            v_mask = wrap(shl(torch.ones_like(width), width).to(torch.int64) - 1)
            val = torch.where(role[:, c] == 2, reads[c - 1] & v_mask, val)
        planes.append(torch.where(bs[:, c] > 0, val, 0))
    return torch.stack(planes, dim=1).to(torch.int32)


def _finish_planes(mix, shift_vals, bs, mixbits, mixres, role, out_chan, filled, C, depth):
    """mix: (F, C*B) channel-major lanes.  Returns the C SMPTE-ordered (F, B)
    output planes (int64 holding int32 values)."""
    B = mix.shape[1] // C
    chans = [mix[:, c * B:(c + 1) * B].to(torch.int64) for c in range(C)]
    # Stereo un-decorrelation (matrix.go:38-49), wrapping int32:
    #   left = u + v - ((mixres*v) >> mixbits); right = left - v
    for c in range(C - 1):
        is_u = role[:, c] == 1
        uv, vv = chans[c], chans[c + 1]
        mres = mixres[:, c].to(torch.int64)
        corr = sshr(wrap(mres * vv), mixbits[:, c])
        mixed = is_u & (mres != 0)
        left = torch.where(mixed, wrap(uv + vv - corr), uv)
        right = torch.where(mixed, wrap(left - vv), vv)
        chans[c] = torch.where(is_u, left, chans[c])
        chans[c + 1] = torch.where(is_u, right, chans[c + 1])
    # Shift re-insert (val << bs*8) | shift bits (matrix.go:129-131), a
    # logical shift with the count clamped to 31; only the 24/32-bit writers
    # take a shift buffer.
    if depth in (24, 32):
        for c in range(C):
            shifted = shl(chans[c], (bs[:, c] * 8).clamp(max=31))
            shifted = shifted | shift_vals[:, c].to(torch.int64)
            chans[c] = torch.where(bs[:, c] > 0, shifted, chans[c])
    # 20-bit output is stored << 4 (matrix.go:91-101).
    if depth == 20:
        chans = [shl(p, 4) for p in chans]
    # MPEG -> SMPTE remap by select; slots no element decoded into stay 0.
    planes = []
    for c_out in range(C):
        acc = torch.zeros_like(chans[0])
        for c in range(C):
            sel = (filled[:, c] != 0) & (out_chan[:, c] == c_out)
            acc = torch.where(sel, chans[c], acc)
        planes.append(acc)
    return planes


def pack_output(out, depth):
    """Interleaved little-endian PCM as the matrix.go writers lay it out:
    (B, F, C) -> 16-bit (B, F*C) int16, 20/24-bit (B, F*C*3) uint8 triples,
    32-bit (B, F*C) int32."""
    B, F, C = out.shape
    flat = out.reshape(B, F * C)
    if depth == 16:
        return flat.to(torch.int16)
    if depth in (20, 24):
        x = flat.to(torch.int64)
        u8 = torch.stack([(x >> s) & 0xFF for s in (0, 8, 16)], dim=-1).to(torch.uint8)
        return u8.reshape(B, F * C * 3)
    return flat


def finish_packed(mix, shift_vals, bs, mixbits, mixres, role, out_chan, filled, *, C, depth):
    """The samples in SMPTE order, packed as PCM, with the interleave fused
    where the JAX package fuses it.

    16-bit with an even C: channels 2i and 2i + 1 of frame f pack into one
    int32 word whose little-endian bytes are the two little-endian int16
    samples (matrix.go:30-63); (B, F*C/2) int32.  20/24-bit with F*C % 4 == 0: each four
    3-byte samples of the sample stream s = f*C + c become three
    little-endian int32 words (matrix.go:91-131); (B, F*C*3/4) int32.  Every
    other case is `pack_output` of the samples.  ``shift_vals`` (F, C, B) is
    read at depth 24 and 32 only."""
    F = mix.shape[0]
    planes = _finish_planes(mix, shift_vals, bs, mixbits, mixres, role, out_chan, filled, C, depth)
    if depth in (20, 24) and (F * C) % 4 == 0:
        x = torch.stack(planes, dim=1).reshape(F * C, -1)
        s0, s1, s2, s3 = x[0::4], x[1::4], x[2::4], x[3::4]
        w0 = (s0 & 0xFFFFFF) | shl(s1, 24)
        w1 = (ushr(s1, 8) & 0xFFFF) | shl(s2, 16)
        w2 = (ushr(s2, 16) & 0xFF) | shl(s3 & 0xFFFFFF, 8)
        w = torch.stack([w0, w1, w2], dim=-1)  # (F*C/4, B, 3)
        return w.transpose(0, 1).reshape(w.shape[1], (F * C * 3) // 4).to(torch.int32)
    if depth == 16 and C % 2 == 0:
        pairs = [
            wrap((planes[i] & 0xFFFF) | ((planes[i + 1] & 0xFFFF) << 16)) for i in range(0, C, 2)
        ]
        packed = torch.stack(pairs, dim=-1).transpose(0, 1)  # (B, F, C/2)
        return packed.reshape(packed.shape[0], F * C // 2).to(torch.int32)
    samples = torch.stack(planes, dim=-1).transpose(0, 1).to(torch.int32)  # (B, F, C)
    return pack_output(samples, depth)
