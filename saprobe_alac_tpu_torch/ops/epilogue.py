"""Phase 3: shift region, stereo unmix, channel remap and PCM packing.

Counterpart of saprobe_alac_tpu/ops/epilogue.py `extract_shift_kernel`,
`_finish_planes`, `pack_output` and `finish_packed` for C <= 2 at
every depth (16, 20, 24, 32).  Plain PyTorch around the raw reader: the JAX
package computes these in XLA outside any Pallas kernel.  Values are int64
tensors holding int32 patterns; every sum and shift that can leave the int32
range is wrapped (torchint).
"""

from __future__ import annotations

import torch

from .raw_reader import raw_read
from .torchint import shl, sshr, ushr, wrap


def shift_reads(shift_base, bs, role, ns):
    """The raw reader's lane inputs (base, step, width, act, n) for the shift
    region of column 0, contiguous int32.

    Mono channels read consecutive ``bs*8``-bit values; a CPE interleaves
    U/V (decoder.go:314-321, 492-502), so the U channel reads each
    ``(u << w) | v`` pair as ONE 2w-bit field.  In the single-slot layout
    column 1 is never a reader of its own: it holds role 2 (the V half of
    column 0's pair) or bs 0 (walk.py ``cols``), so one read of column 0
    serves both; the JAX package runs an all-inactive read for column 1."""
    width = bs[:, 0] * 8
    stride = torch.where(role[:, 0] == 0, width, 2 * width)
    act = (bs[:, 0] > 0) & (role[:, 0] != 2)
    lanes = (shift_base[:, 0], stride, stride, act, ns)
    return tuple(x.to(torch.int32).contiguous() for x in lanes)


def extract_shift(words, shift_base, bs, role, ns, *, F, C):
    """The shift region's low bits: (F, C, B) int32 F-major planes, equal to
    the JAX package's `extract_shift_kernel` (see `shift_reads`)."""
    # Shift bits are OR-ed back in unsigned.
    read = raw_read(words, *shift_reads(shift_base, bs, role, ns), F=F, signed=False)
    read = read[:F].to(torch.int64)
    # U lanes: high half of the fused read; mono lanes: the value itself.
    planes = [torch.where(role[:, 0] == 1, ushr(read, bs[:, 0] * 8), read)]
    if C > 1:
        # V lanes: low half of column 0's fused read.
        v_width = bs[:, 1] * 8
        v_mask = wrap(shl(torch.ones_like(v_width), v_width).to(torch.int64) - 1)
        planes.append(torch.where(role[:, 1] == 2, read & v_mask, 0))
    planes = [torch.where(bs[:, c] > 0, p, 0) for c, p in enumerate(planes)]
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

    16-bit stereo: the (left, right) pair of frame f packs into one int32
    word whose little-endian bytes are the two little-endian int16 samples
    (matrix.go:30-63); (B, F) int32.  20/24-bit with F*C % 4 == 0: each four
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
    if depth == 16 and C == 2:
        left, right = planes
        packed = wrap((left & 0xFFFF) | ((right & 0xFFFF) << 16))
        return packed.T.contiguous().to(torch.int32)
    samples = torch.stack(planes, dim=-1).transpose(0, 1).to(torch.int32)  # (B, F, C)
    return pack_output(samples, depth)
