"""Phase 3: shift region, stereo unmix, channel remap and PCM packing.

Counterpart of saprobe_alac_tpu/ops/epilogue.py `extract_shift_kernel`,
`_finish_planes`, `pack_output` and `finish_packed` for C = 1..8 at
every depth (16, 20, 24, 32).  `epilogue` is the decode path's entry: for
CUDA tensors the raw reader (24/32 bits) and one launch of the epilogue
kernel (csrc/epilogue_kernel.cu, `epilogue_kernel`), for CPU tensors its
plain twin, `extract_shift` and `finish_packed`.  The JAX package computes
these in XLA outside any Pallas kernel.  In the twin, values are int64
tensors holding int32 patterns; every sum and shift that can leave the int32
range is wrapped (torchint).
"""

from __future__ import annotations

import torch

from .. import _build
from ..native import BYTES_PER_SAMPLE
from .raw_reader import raw_read
from .torchint import shl, sshr, ushr, wrap


def shift_reads(shift_base, bs, role, ns):
    """The raw reader's inputs for the shift region of every channel:
    (base, step, width, act, n, row), contiguous int32, lanes channel-major
    (lane c*B + b reads channel c of packet ``row`` = b).

    Mono channels read consecutive ``bs*8``-bit values; a CPE interleaves
    U/V (decoder.go:314-321, 492-502), so the U channel reads each
    ``(u << w) | v`` pair as ONE 2w-bit field and the V channel (role 2)
    reads nothing of its own: it takes the low half of its partner's read."""
    B, C = bs.shape
    width = bs * 8
    stride = torch.where(role == 0, width, 2 * width)
    act = (bs > 0) & (role != 2)
    row = torch.arange(B, device=bs.device).repeat(C)
    lanes = (*(x.T.reshape(C * B) for x in (shift_base, stride, stride, act)), ns.repeat(C), row)
    return tuple(x.to(torch.int32).contiguous() for x in lanes)


def extract_shift(words, shift_base, bs, role, ns, *, F, C):
    """The shift region's low bits: (F, C, B) int32 F-major planes, equal to
    the JAX package's `extract_shift_kernel` (epilogue.py:109-142): one raw
    read over every (channel, packet) lane of `shift_reads` (the lanes of a
    V channel, or of a channel without a shift region, are inactive and
    read nothing), the V halves split from channel c - 1's fused read."""
    B = words.shape[0]
    *lanes, row = shift_reads(shift_base[:, :C], bs[:, :C], role[:, :C], ns)
    # Shift bits are OR-ed back in unsigned.
    out = raw_read(words, *lanes, F=F, signed=False, row=row)[:F].to(torch.int64)
    reads = [out[:, c * B : (c + 1) * B] for c in range(C)]
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


def packed_layout(F, C, depth):
    """(dtype, words a row) of `finish_packed`'s output for F frames of C
    channels; each row holds F*C*BYTES_PER_SAMPLE[depth] bytes whatever
    the dtype."""
    if depth in (20, 24):
        if (F * C) % 4 == 0:
            return torch.int32, F * C * 3 // 4
        return torch.uint8, F * C * 3
    if depth == 16:
        return (torch.int32, F * C // 2) if C % 2 == 0 else (torch.int16, F * C)
    return torch.int32, F * C


def epilogue_kernel(mix, raw, bs, mixbits, mixres, role, out_chan, filled, *, C, depth):
    """One launch of the epilogue kernel: `finish_packed`'s tensor, byte for
    byte, from the LPC's samples ``mix`` (F, C*B), the raw reader's output
    ``raw`` for the shift region (at least F rows of C*B lanes; None below
    24 bits: the kernel reads it at 24 and 32 bits only, where the twin
    takes `extract_shift` of the same reads) and the walk's (B, C) fields,
    all contiguous int32 on one CUDA device."""
    if depth not in BYTES_PER_SAMPLE or not 1 <= C <= 8:
        raise ValueError(f"no epilogue kernel for depth {depth}, C = {C}")
    if mix.device.type != "cuda":
        raise ValueError(f"no epilogue kernel for device {mix.device}")
    F, L = mix.shape
    B = L // C
    if B * C != L:
        raise ValueError(f"mix has {L} lanes, not a multiple of C = {C}")
    fields = (bs, mixbits, mixres, role, out_chan, filled)
    shift = depth in (24, 32)
    if shift and (raw is None or raw.dim() != 2 or raw.shape[0] < F or raw.shape[1] != L):
        raise ValueError(f"raw: want at least {F} rows of {L} lanes at depth {depth}")
    named = zip(("mix", "raw", "bs", "mixbits", "mixres", "role", "out_chan", "filled"),
                (mix, raw if shift else None, *fields))
    for name, t in named:
        if t is None:
            continue
        if t.device != mix.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous int32 on {mix.device}")
        if name not in ("mix", "raw") and t.shape != (B, C):
            raise ValueError(f"{name}: want shape ({B}, {C}), got {tuple(t.shape)}")
    dtype, words = packed_layout(F, C, depth)
    out = torch.empty((B, words), dtype=dtype, device=mix.device)
    vec = (F * C * BYTES_PER_SAMPLE[depth]) % 16 == 0 and out.data_ptr() % 16 == 0
    lib = _build.load()
    with torch.cuda.device(mix.device):
        stream = torch.cuda.current_stream(mix.device).cuda_stream
        rc = lib.alac_epilogue_launch(
            mix.data_ptr(), raw.data_ptr() if shift else None, *(t.data_ptr() for t in fields),
            out.data_ptr(), B, C, F, depth, int(vec), stream,
        )
    if rc != 0:
        raise RuntimeError(f"epilogue kernel launch failed: CUDA error {rc}")
    _build.count_launch("epilogue")
    return out


def epilogue(words, mix, w, *, F, C, depth):
    """The decode path's epilogue: the PCM rows of a batch (`finish_packed`'s
    tensor) from its staged words, the LPC's samples ``mix`` (F, C*B) and
    the walk's result ``w``.  CUDA tensors take the raw reader for the shift
    region (24/32 bits) and the epilogue kernel, with no fallback; CPU
    tensors take the plain twin."""
    fields = (w.bs, w.mixbits, w.mixres, w.role, w.out_chan, w.filled)
    if mix.device.type == "cpu":
        shift_vals = None
        if depth in (24, 32):
            shift_vals = extract_shift(words, w.shift_base, w.bs, w.role, w.ns, F=F, C=C)
        return finish_packed(mix, shift_vals, *fields, C=C, depth=depth)
    raw = None
    if depth in (24, 32):
        *lanes, row = shift_reads(w.shift_base, w.bs, w.role, w.ns)
        raw = raw_read(words, *lanes, F=F, signed=False, row=row)
    return epilogue_kernel(mix, raw, *fields, C=C, depth=depth)
