"""Raw reader: fixed-stride bit fields, one packet per lane.

Counterpart of saprobe_alac_tpu/ops/walk_kernel.py `raw_read_pallas`
(`_raw_reader_kernel`), without its TPU tiling and on the (B, W) row-major
words that `TorchBatchDecoder._stage` uploads:

    out (F_pad, L) int32   out[t, l] = the width[l]-bit field at bit
                           base[l] + t*step[l] of packet row[l], for
                           t < n[l] on active lanes, sign-extended when
                           ``signed``; 0 elsewhere

F_pad is F rounded up to 16; width is 1..32.  ``row`` (L,) maps each lane
to its packet, so one call reads every channel of a batch (lanes
channel-major); without it lane l reads packet l (L = B).  Words outside
[0, W) read as zero (streambits.gather_word), and so does every word of a
row outside [0, B).  `raw_read` launches the CUDA kernel
(csrc/raw_reader_kernel.cu) for CUDA tensors and runs the plain version,
`raw_read_reference`, for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from .torchint import sshr, u, ushr, wrap
from .walk_kernel import f_pad

#: Rows per chunk of the plain version: bounds its (B, rows) int64 temporaries.
_CHUNK = 256


def raw_read(words, base, step, width, act, n, *, F, signed=False, row=None):
    """Read the fields; CUDA tensors launch the kernel, CPU tensors run the
    plain version."""
    args = (words, base, step, width, act, n)
    if words.device.type == "cpu":
        return raw_read_reference(*args, F=F, signed=signed, row=row)
    if words.device.type != "cuda":
        raise ValueError(f"no raw reader kernel for device {words.device}")
    B, W = words.shape
    L = base.shape[0] if row is None else row.shape[0]
    if row is None and L != B:
        raise ValueError(f"{L} lanes for {B} packets need a row map")
    named = zip(("words", "base", "step", "width", "act", "n", "row"), (*args, row))
    for name, t in named:
        if t is None:
            continue
        if t.device != words.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous int32 on {words.device}")
        if name != "words" and t.shape != (L,):
            raise ValueError(f"{name}: want shape ({L},), got {tuple(t.shape)}")
    Fp = f_pad(F)
    out = torch.empty((Fp, L), dtype=torch.int32, device=words.device)
    lib = _build.load()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.alac_raw_read_launch(
            words.data_ptr(), W, B, None if row is None else row.data_ptr(), base.data_ptr(),
            step.data_ptr(), width.data_ptr(), act.data_ptr(), n.data_ptr(), out.data_ptr(), L,
            Fp, int(signed), stream,
        )
    if rc != 0:
        raise RuntimeError(f"raw reader kernel launch failed: CUDA error {rc}")
    _build.count_launch("raw_read")
    return out


def raw_read_reference(words, base, step, width, act, n, *, F, signed=False, row=None):
    """Plain PyTorch raw reader, vectorised over (lane, row) in chunks of
    rows: each field is one 32-bit window (two word gathers) shifted right."""
    L = torch.int64
    B, W = words.shape
    lanes = base.shape[0]
    Fp = f_pad(F)
    out = torch.zeros((Fp, lanes), dtype=torch.int32, device=words.device)
    if row is None:
        row = torch.arange(lanes, device=words.device)
    row = row.to(L)[:, None]
    inside = (row >= 0) & (row < B)
    flat = words.reshape(-1)
    rows = torch.where(act != 0, n, 0).to(L)[:, None]
    base, step = base.to(L)[:, None], step.to(L)[:, None]
    cut = 32 - width.to(L).clamp(min=1)[:, None]
    shift = sshr if signed else ushr

    def word(wi):
        """Unsigned words at per-(lane, row) indices wi; zero outside."""
        ok = inside & (wi >= 0) & (wi < W)
        if not flat.numel():
            return torch.zeros_like(wi)
        return torch.where(ok, u(flat[torch.where(ok, row * W + wi, 0)]), 0)

    for t0 in range(0, Fp, _CHUNK):
        t = torch.arange(t0, min(t0 + _CHUNK, Fp), dtype=L, device=words.device)[None, :]
        pos = base + t * step
        wi, r = pos >> 5, pos & 31
        win = wrap(((word(wi) << r) & 0xFFFFFFFF) | ((word(wi + 1) >> 1) >> (31 - r)))
        out[t0 : t0 + t.shape[1]] = torch.where(t < rows, shift(win, cut), 0).T.to(torch.int32)
    return out
