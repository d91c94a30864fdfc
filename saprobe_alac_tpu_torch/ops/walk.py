"""Phase 1: the element walk of a batch of packets.

Counterpart of saprobe_alac_tpu/ops/walk.py `_walk_batch`.  One packet-kernel
launch per batch (walk_kernel.py `dense_packet`) walks every element of
every packet, for every channel count C = 1..8 and every element layout:
SCE, CPE, SCE+SCE stereo, DSE and FIL elements before or between them, END.
It stands for both of the JAX package's layouts: the slot loop
(walk.py:1110-1189) and the single-slot layout it takes for C <= 2
(walk.py:1077-1108), with no slot loop, commits or merge on this side.  A
lane gets ERR_SLOTS only when its packet spends the slot budget of C + 4
elements without filling its channels or reaching END.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .walk_kernel import (  # noqa: F401  (ERR_* re-exported)
    ERR_ELEMENT,
    ERR_HEADER,
    ERR_NONE,
    ERR_OVERRUN,
    ERR_SAMPLES,
    ERR_SHIFT,
    ERR_SLOTS,
    ERR_WIDTH,
    PACKET_FIELDS,
    dense_packet,
)
from ..codec.element import CHANNEL_LAYOUT_OFFSETS


class WalkResult(NamedTuple):
    """Per-batch phase-1 outputs (all int32), as saprobe_alac_tpu WalkResult
    but with ``res`` the packet kernel's rows (C, F_pad, B): plane c holds
    channel c's residuals (the JAX package hands on (F, C, B))."""

    res: torch.Tensor
    err: torch.Tensor  # (B,)
    ns: torch.Tensor  # (B,) decoded samples per packet
    order: torch.Tensor  # (B, C)
    mode: torch.Tensor
    den: torch.Tensor
    cb: torch.Tensor  # chan_bits
    bs: torch.Tensor  # bytes shifted (0 for escape)
    esc: torch.Tensor
    esc_base: torch.Tensor
    esc_cb: torch.Tensor
    shift_base: torch.Tensor
    coefs: torch.Tensor  # (B, C, 32)
    mixbits: torch.Tensor
    mixres: torch.Tensor
    role: torch.Tensor  # 0=mono, 1=pair-U, 2=pair-V
    out_chan: torch.Tensor  # SMPTE output channel index
    filled: torch.Tensor  # 1 if an element decoded into the channel


def channel_offsets(C: int, device) -> torch.Tensor:
    """(C,) int32 on ``device``: bitstream channel -> output channel
    (CHANNEL_LAYOUT_OFFSETS).  A decode program builds it once: building it
    is a host-to-device copy, which a CUDA graph capture refuses."""
    if not 1 <= C <= 8:
        raise ValueError(f"the walk takes C = 1..8, got {C}")
    return torch.tensor(CHANNEL_LAYOUT_OFFSETS[C - 1], dtype=torch.int32, device=device)


def walk_batch(words, size_bits, *, F, C, depth, pb, mb, kb, offsets=None) -> WalkResult:
    """Run phase 1 over a packed (B, W) int32 batch of big-endian words.

    The batch's device (that of ``words``) picks the implementation: the
    packet kernel on a CUDA device, its plain version on the CPU.
    ``offsets``: `channel_offsets(C, words.device)`, built here when not
    given."""
    if offsets is None:
        offsets = channel_offsets(C, words.device)
    rows, err, ns, meta, coefs = dense_packet(
        words.contiguous(), size_bits.to(torch.int32).contiguous(), offsets,
        kb=kb, F=F, C=C, depth=depth, pb_cfg=pb, mb_cfg=mb,
    )
    return WalkResult(res=rows, err=err, ns=ns, coefs=coefs, **dict(zip(PACKET_FIELDS, meta)))
