"""Phase 1: the element walk of a batch of packets.

Counterpart of saprobe_alac_tpu/ops/walk.py `_walk_batch`, with its two
layouts:

``fused=True``, the single-slot layout (C <= 2), the counterpart of
`slot_body_dense(first=True, single=True)` and walk.py:1077-1108.  One
element-kernel call per batch parses each packet's one SCE or CPE and runs
its entropy walk; the metadata is committed into (B, C) arrays.  Lanes whose
layout needs more than one element slot (SCE+SCE stereo, DSE/FIL prefixes,
trailing elements) get ERR_SLOTS and are decoded by the exact host fallback.
A GPU thread indexes a lane directly, so the JAX package's one-hot `put`
selects (walk.py:1030-1036) become plain indexed writes into column 0 (the
U channel) and column 1 (the V channel of a CPE).

``fused=False``, every element layout for C = 1..8, the counterpart of the
slot loop (walk.py:1110-1189).  One packet-kernel call per batch walks every
element of every packet (walk_kernel.py `dense_packet`): no slot loop, no
commits and no merge on this side.
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
    M_BSF,
    M_COEFS_U,
    M_COEFS_V,
    M_COMP,
    M_CPE,
    M_DEN_U,
    M_DEN_V,
    M_ESC,
    M_ESC_BASE,
    M_MIXBITS,
    M_MIXRES,
    M_MODE_U,
    M_MODE_V,
    M_NS,
    M_NUM_U,
    M_NUM_V,
    M_SCE,
    M_SHIFT_BASE,
    M_TAG,
    PACKET_FIELDS,
    dense_element,
    dense_packet,
)
from ..encoder.spec import CHANNEL_LAYOUT_OFFSETS


class WalkResult(NamedTuple):
    """Per-batch phase-1 outputs (all int32), as saprobe_alac_tpu WalkResult
    but with ``res`` the walk kernel's rows: (passes, F_pad, B) from the
    single-slot layout, (C, F_pad, B) from the packet walk; either way plane
    c holds channel c's residuals (the JAX package hands on (F, C, B))."""

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


def walk_batch(words, size_bits, *, F, C, depth, pb, mb, kb, fused=None) -> WalkResult:
    """Run phase 1 over a packed (B, W) int32 batch of big-endian words.

    ``fused`` picks the layout (see the module text); left out, it is the
    single-slot layout for C <= 2 and the packet walk above, the choice of
    the JAX package's decode path.  The batch's device (that of ``words``)
    picks the implementation: the CUDA kernels on a CUDA device, their plain
    versions on the CPU."""
    if not 1 <= C <= 8:
        raise ValueError(f"the walk takes C = 1..8, got {C}")
    if fused is None:
        fused = C <= 2
    if fused and C > 2:
        raise ValueError(f"the single-slot layout takes C <= 2, got {C}")
    B = words.shape[0]
    dev = words.device
    i32 = torch.int32
    size_bits = size_bits.to(i32).contiguous()
    if not fused:
        offsets = torch.tensor(CHANNEL_LAYOUT_OFFSETS[C - 1], dtype=i32, device=dev)
        rows, err, ns, meta, coefs = dense_packet(
            words.contiguous(), size_bits, offsets,
            kb=kb, F=F, C=C, depth=depth, pb_cfg=pb, mb_cfg=mb,
        )
        return WalkResult(res=rows, err=err, ns=ns, coefs=coefs, **dict(zip(PACKET_FIELDS, meta)))

    # Past-end check before the tag read (decoder.go:143-145).
    bitpos = torch.zeros(B, dtype=i32, device=dev)
    over = size_bits >> 3 <= 0
    err = torch.where(over, ERR_OVERRUN, 0).to(i32)
    active = ~over
    rows, _, kerr, meta = dense_element(
        words.contiguous(), bitpos, active.to(i32), size_bits,
        torch.full((B,), F, dtype=i32, device=dev),
        torch.full((B,), int(C >= 2), dtype=i32, device=dev),
        kb=kb, F=F, depth=depth, pb_cfg=pb, mb_cfg=mb, passes=2 if C > 1 else 1,
    )
    err = torch.where(active & (kerr != ERR_NONE), kerr, err)

    is_sce = active & (meta[M_SCE] == 1)
    is_cpe = active & (meta[M_CPE] == 1)
    is_comp = active & (meta[M_COMP] == 1)
    is_escape = active & (meta[M_ESC] == 1)
    is_elem = is_sce | is_cpe
    tag = meta[M_TAG]
    cpe_break = active & (tag == 1) & (C < 2)
    is_end = active & (tag == 7)
    ns = torch.where(is_elem, meta[M_NS], F)
    bsf = meta[M_BSF]
    cb_comp = depth - bsf * 8 + is_cpe.to(i32)
    esc_cb = torch.where(is_cpe, depth, depth - bsf * 8)
    pair_comp = is_cpe & is_comp

    def cols(u_val, v_val=None):
        """(B, C): column 0 where the lane decoded an element, column 1
        (``v_val``, default ``u_val``) where it decoded a CPE; else 0."""
        out = torch.zeros((B, C), dtype=i32, device=dev)
        out[:, 0] = torch.where(is_elem, u_val, 0)
        if C > 1:
            out[:, 1] = torch.where(is_cpe, u_val if v_val is None else v_val, 0)
        return out

    def comp(x):
        return torch.where(is_comp, x, 0)

    escf = is_escape.to(i32)
    cb = torch.where(is_comp, cb_comp, esc_cb)
    coefs = torch.zeros((B, C, 32), dtype=i32, device=dev)
    coefs[:, 0] = torch.where(is_comp[:, None], meta[M_COEFS_U:M_COEFS_U + 32].T, 0)
    if C > 1:
        coefs[:, 1] = torch.where(pair_comp[:, None], meta[M_COEFS_V:M_COEFS_V + 32].T, 0)

    # A lane is done after its one element fills every channel, or at END.
    chan_new = is_sce.to(i32) + 2 * is_cpe.to(i32)
    done = is_end | cpe_break | (chan_new >= C)
    err = torch.where(~done & (err == ERR_NONE), ERR_SLOTS, err)

    return WalkResult(
        res=rows,
        err=err.to(i32),
        ns=ns.to(i32),
        order=cols(comp(meta[M_NUM_U]), comp(meta[M_NUM_V])),
        mode=cols(comp(meta[M_MODE_U]), comp(meta[M_MODE_V])),
        den=cols(comp(meta[M_DEN_U]), comp(meta[M_DEN_V])),
        cb=cols(cb),
        bs=cols(comp(bsf)),
        esc=cols(escf),
        esc_base=cols(meta[M_ESC_BASE]),
        esc_cb=cols(esc_cb),
        shift_base=cols(meta[M_SHIFT_BASE]),
        coefs=coefs,
        mixbits=cols(torch.where(pair_comp, meta[M_MIXBITS], 0)),
        mixres=cols(torch.where(pair_comp, meta[M_MIXRES], 0)),
        role=cols(is_cpe.to(i32), torch.full_like(escf, 2)),
        # The one element fills output channels 0 (and 1): the first entry of
        # the mono and stereo layouts (codec/element.py CHANNEL_LAYOUT_OFFSETS).
        out_chan=cols(torch.zeros_like(escf), torch.ones_like(escf)),
        filled=cols(torch.ones_like(escf)),
    )
