"""Raw reader: fixed-stride bit fields, one packet per lane.

Counterpart of saprobe_alac_tpu/ops/walk_kernel.py `raw_read_pallas`
(`_raw_reader_kernel`), without its TPU tiling and on the (B, W) row-major
words that `TorchBatchDecoder._stage` uploads:

    out (F_pad, B) int32   out[t, b] = the width[b]-bit field at bit
                           base[b] + t*step[b] for t < n[b] on active lanes,
                           sign-extended when ``signed``; 0 elsewhere

F_pad is F rounded up to 16; width is 1..32.  Words outside [0, W) read as
zero (streambits.gather_word).  `raw_read` launches the CUDA kernel
(csrc/raw_reader_kernel.cu) for CUDA tensors and runs the plain version,
`raw_read_reference`, for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from .streambits import window32
from .torchint import sshr, ushr
from .walk_kernel import f_pad

#: Rows per chunk of the plain version: bounds its (B, rows) int64 temporaries.
_CHUNK = 256


def raw_read(words, base, step, width, act, n, *, F, signed=False):
    """Read the fields; CUDA tensors launch the kernel, CPU tensors run the
    plain version."""
    args = (words, base, step, width, act, n)
    if words.device.type == "cpu":
        return raw_read_reference(*args, F=F, signed=signed)
    if words.device.type != "cuda":
        raise ValueError(f"no raw reader kernel for device {words.device}")
    B, W = words.shape
    for name, t in zip(("words", "base", "step", "width", "act", "n"), args):
        if t.device != words.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous int32 on {words.device}")
        if name != "words" and t.shape != (B,):
            raise ValueError(f"{name}: want shape ({B},), got {tuple(t.shape)}")
    Fp = f_pad(F)
    out = torch.empty((Fp, B), dtype=torch.int32, device=words.device)
    lib = _build.load()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.alac_raw_read_launch(
            words.data_ptr(), W, base.data_ptr(), step.data_ptr(), width.data_ptr(),
            act.data_ptr(), n.data_ptr(), out.data_ptr(), B, Fp, int(signed), stream,
        )
    if rc != 0:
        raise RuntimeError(f"raw reader kernel launch failed: CUDA error {rc}")
    _build.count_launch("raw_read")
    return out


def raw_read_reference(words, base, step, width, act, n, *, F, signed=False):
    """Plain PyTorch raw reader, vectorised over (lane, row) in chunks of
    rows: each field is one 32-bit window (two word gathers) shifted right."""
    L = torch.int64
    B = words.shape[0]
    Fp = f_pad(F)
    out = torch.zeros((Fp, B), dtype=torch.int32, device=words.device)
    rows = torch.where(act != 0, n, 0).to(L)[:, None]
    base, step = base.to(L)[:, None], step.to(L)[:, None]
    cut = 32 - width.to(L).clamp(min=1)[:, None]
    shift = sshr if signed else ushr
    for t0 in range(0, Fp, _CHUNK):
        t = torch.arange(t0, min(t0 + _CHUNK, Fp), dtype=L, device=words.device)[None, :]
        val = shift(window32(words, base + t * step), cut)
        out[t0 : t0 + t.shape[1]] = torch.where(t < rows, val, 0).T.to(torch.int32)
    return out
