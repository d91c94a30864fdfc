"""Element kernel: SCE/CPE header + coefficient parse and the two-pass
adaptive Golomb-Rice walk, one packet per lane.

Counterpart of saprobe_alac_tpu/ops/walk_kernel.py `dense_element_pallas`
(`_element_kernel`).  `dense_element` launches the CUDA kernel
(csrc/element_kernel.cu) for CUDA tensors and runs the plain PyTorch version,
`dense_element_reference`, for CPU tensors.  Both return the quantities the
Pallas kernel returns, without its TPU tiling:

    rows (passes, F_pad, B)  residual row t of pass p (U, then V) per lane;
                             the dense emission schedule writes every row,
                             zeros where a lane has nothing to emit
    bitpos (B,)              post-entropy cursor of compressed lanes, else
                             the input cursor
    err (B,)                 ERR_* code
    meta (META_ROWS, B)      parsed element fields, rows M_*

F_pad is F rounded up to 16.  All int32.  Parity: golomb.go:112-253,
decoder.go:210-265/348-460, bitbuffer.go:28-32 (zero reads past the end).
"""

from __future__ import annotations

import torch

from .. import _build
from .streambits import vread, window32
from .torchint import clz, lg3a, shl, sshr, u, ushr, wrap

# Error codes (saprobe_alac_tpu/ops/walk.py:33-41).
ERR_NONE = 0
ERR_OVERRUN = 1
ERR_ELEMENT = 2
ERR_HEADER = 3
ERR_SHIFT = 4
ERR_SAMPLES = 5
ERR_SLOTS = 6
ERR_WIDTH = 7

# Metadata rows (saprobe_alac_tpu/ops/walk_kernel.py:118-126).
META_ROWS = 82
(
    M_TAG, M_NS, M_BSF, M_ESC, M_COMP, M_MIXBITS, M_MIXRES,
    M_MODE_U, M_DEN_U, M_NUM_U, M_MODE_V, M_DEN_V, M_NUM_V,
    M_SHIFT_BASE, M_ESC_BASE, M_ESC_END, M_SCE, M_CPE,
) = range(18)
M_COEFS_U = 18  # rows 18..49
M_COEFS_V = 50  # rows 50..81


def f_pad(F: int) -> int:
    """Rows per pass: F rounded up to 16."""
    return ((F + 15) // 16) * 16


def dense_element(
    words, bitpos, pact, size_bits, ns_in, allow_cpe,
    *, kb, F, depth, pb_cfg, mb_cfg, passes,
):
    """Run the element kernel over a (B, W) batch of big-endian words.

    CUDA tensors launch the kernel, CPU tensors run the plain version."""
    args = (words, bitpos, pact, size_bits, ns_in, allow_cpe)
    kw = dict(kb=kb, F=F, depth=depth, pb_cfg=pb_cfg, mb_cfg=mb_cfg, passes=passes)
    if words.device.type == "cpu":
        return dense_element_reference(*args, **kw)
    if words.device.type != "cuda":
        raise ValueError(f"no element kernel for device {words.device}")
    B, W = words.shape
    for name, t in zip(("words", "bitpos", "pact", "size_bits", "ns_in", "allow_cpe"), args):
        if t.device != words.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous int32 on {words.device}")
        if name != "words" and t.shape != (B,):
            raise ValueError(f"{name}: want shape ({B},), got {tuple(t.shape)}")
    if passes not in (1, 2):
        raise ValueError(f"passes must be 1 or 2, got {passes}")
    Fp = f_pad(F)
    dev = words.device
    rows = torch.empty((passes, Fp, B), dtype=torch.int32, device=dev)
    bp_out = torch.empty(B, dtype=torch.int32, device=dev)
    err = torch.empty(B, dtype=torch.int32, device=dev)
    meta = torch.empty((META_ROWS, B), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.alac_element_launch(
            words.data_ptr(), W, bitpos.data_ptr(), pact.data_ptr(),
            size_bits.data_ptr(), ns_in.data_ptr(), allow_cpe.data_ptr(),
            rows.data_ptr(), bp_out.data_ptr(), err.data_ptr(), meta.data_ptr(),
            B, F, Fp, passes, kb, depth, pb_cfg, mb_cfg, stream,
        )
    if rc != 0:
        raise RuntimeError(f"element kernel launch failed: CUDA error {rc}")
    _build.count_launch("element")
    return rows, bp_out, err, meta


def _parse(words, bitpos, pa, size_bits, ns_in, allow_cpe, F, depth):
    """Tag, element header, predictor headers and coefficients
    (walk_kernel.py:829-960): same reads, error codes and precedence."""
    z = torch.zeros_like(bitpos)
    tag = vread(words, bitpos, 3)
    p0 = bitpos + 3
    is_sce = pa & ((tag == 0) | (tag == 3))
    is_cpe = pa & (tag == 1) & allow_cpe
    is_elem = is_sce | is_cpe
    err = torch.where(pa & ((tag == 2) | (tag == 5)), ERR_ELEMENT, z)

    unused = vread(words, p0 + 4, 12)
    hdr4 = vread(words, p0 + 16, 4)
    partial, bsf, escf = hdr4 >> 3, (hdr4 >> 1) & 3, hdr4 & 1
    err = torch.where(is_elem & (unused != 0), ERR_HEADER, err)
    err = torch.where(is_elem & (bsf == 3), ERR_SHIFT, err)

    def keep(is_elem, is_sce, is_cpe):
        is_elem = is_elem & (err == ERR_NONE)
        return is_elem, is_sce & is_elem, is_cpe & is_elem

    is_elem, is_sce, is_cpe = keep(is_elem, is_sce, is_cpe)
    p = p0 + 20
    ns_new = torch.where(is_elem & (partial == 1), vread(words, p, 32), ns_in)
    err = torch.where(is_elem & ((ns_new > F) | (ns_new < 0)), ERR_SAMPLES, err)
    is_elem, is_sce, is_cpe = keep(is_elem, is_sce, is_cpe)
    p = p + torch.where(is_elem & (partial == 1), 32, 0)
    ns_l = torch.where(is_elem, ns_new, ns_in)

    # chan_bits (decoder.go:230, 371); escape resets (:326, 388).
    cb_comp = depth - bsf * 8 + is_cpe.long()
    esc_cb = torch.where(is_cpe, depth, depth - bsf * 8)
    bad_width = ((escf == 0) & ((cb_comp > 32) | (cb_comp < 1))) | (
        (escf == 1) & (esc_cb < 1)
    )
    err = torch.where(is_elem & bad_width, ERR_WIDTH, err)
    is_elem, is_sce, is_cpe = keep(is_elem, is_sce, is_cpe)
    is_comp = is_elem & (escf == 0)
    is_escape = is_elem & (escf == 1)

    mixbits = vread(words, p, 8)
    mixres8 = vread(words, p + 8, 8)
    mixres = torch.where(mixres8 >= 128, mixres8 - 256, mixres8)

    jj = torch.arange(32, device=words.device)[None, :]

    def pred_header(pc, mask):
        b1 = vread(words, pc, 8)
        b2 = vread(words, pc + 8, 8)
        num = b2 & 31
        cj = vread(words, pc[:, None] + 16 + 16 * jj, 16)
        cj = torch.where(cj >= 32768, cj - 65536, cj)
        coefs = torch.where(mask[:, None] & (jj < num[:, None]), cj, 0)
        return b1 >> 4, b1 & 15, b2 >> 5, num, coefs, pc + 16 + 16 * num

    mode_u, den_u, pbf_u, num_u, coefs_u, p_after_u = pred_header(p + 16, is_comp)
    mode_v, den_v, pbf_v, num_v, coefs_v, p_after_v = pred_header(
        p_after_u, is_cpe & is_comp
    )
    p_pred = torch.where(is_cpe, p_after_v, p_after_u)

    # Shift region skipped (decoder.go:289-293, 453-457); escape raw data
    # begins right after the element header.
    nch = 1 + is_cpe.long()
    p_ent = p_pred + torch.where(is_comp, bsf * 8 * nch * ns_l, 0)
    esc_base = p
    p_esc_end = p + ns_l * esc_cb * nch
    err = torch.where(is_escape & (p_esc_end > size_bits), ERR_OVERRUN, err)
    is_escape = is_escape & (err == ERR_NONE)
    is_comp = is_comp & is_elem & (err == ERR_NONE)

    meta = torch.cat(
        [
            torch.stack([
                tag, ns_l, bsf, is_escape.long(), is_comp.long(), mixbits,
                mixres, mode_u, den_u, num_u, mode_v, den_v, num_v, p_pred,
                esc_base, p_esc_end, is_sce.long(), is_cpe.long(),
            ]),
            coefs_u.T,
            coefs_v.T,
        ]
    )
    return dict(
        err=err, meta=meta, ns=ns_l, is_comp=is_comp, is_escape=is_escape,
        is_cpe=is_cpe, nch=nch, cb_comp=cb_comp, esc_cb=esc_cb, pbf_u=pbf_u,
        pbf_v=pbf_v, p_ent=p_ent, esc_base=esc_base,
    )


def dense_element_reference(
    words, bitpos, pact, size_bits, ns_in, allow_cpe,
    *, kb, F, depth, pb_cfg, mb_cfg, passes,
):
    """Plain PyTorch element decode, vectorised over lanes.

    A loop over the rows: at each step a lane decodes one codeword (its
    window read with torch.gather), drains one zero of a pending zero run,
    reads one raw escape field, or idles and emits 0 — the dense emission
    schedule of walk_kernel.py:401-507.  Internals run in int64 holding
    int32 values; every sum that can overflow is wrapped."""
    L = torch.int64
    B = words.shape[0]
    dev = words.device
    bitpos, size_bits, ns_in = bitpos.to(L), size_bits.to(L), ns_in.to(L)
    P = _parse(words, bitpos, pact != 0, size_bits, ns_in, allow_cpe != 0, F, depth)
    err, ns = P["err"], P["ns"]
    raw = P["is_escape"]
    rstep = P["nch"] * P["esc_cb"]
    rawcb = P["esc_cb"].clamp(min=1)
    raw_vpos = P["esc_base"] + P["esc_cb"]
    max_size = P["cb_comp"]
    pb_u = (pb_cfg * P["pbf_u"]) >> 2
    pb_v = (pb_cfg * P["pbf_v"]) >> 2
    act2v = P["is_cpe"] & (P["is_comp"] | raw) & (ns > 0)
    wb_mask = (1 << kb) - 1 if kb < 32 else -1

    z = torch.zeros(B, dtype=L, device=dev)
    act = (P["is_comp"] | raw) & (ns > 0)
    off = torch.where(raw, P["esc_base"], P["p_ent"])
    count, mean, zmode, zrem, pbl = z, z + mb_cfg, z, z, pb_u

    Fp = f_pad(F)
    rows = torch.zeros((passes, Fp, B), dtype=torch.int32, device=dev)
    for p in range(passes):
        if p == 1:
            # Channel switch: V lanes restart at U's end cursor with fresh
            # state and the V tuning; escape lanes rewind to the V phase of
            # the interleaved raw region (walk_kernel.py:573-597).
            act = act2v & (err == ERR_NONE)
            count, mean, zmode, zrem, pbl = z, z + mb_cfg, z, z, pb_v
            off = torch.where(raw, raw_vpos, off)
        for t in range(Fp):
            if t % 16 == 0 and not bool(act.any()):
                break
            dec = act & (zrem == 0) & ~raw
            zdrain = act & (zrem > 0)
            rawact = act & raw

            # Overrun guard (golomb.go:168-170).
            over = dec & ((off >= size_bits) | (off < 0))
            err = torch.where(over, ERR_OVERRUN, err)
            act = act & ~over
            dec = dec & ~over

            k = torch.clamp(lg3a(u(mean) >> 9), max=kb)
            m = wrap(shl(torch.ones_like(k), k) - 1)
            win = window32(words, off)
            pre = clz(wrap(~win))
            is_esc = pre >= 9
            val_esc = ushr(window32(words, off + 9), 32 - max_size.clamp(min=1))
            v = ushr(shl(win, pre + 1), 32 - k)
            vbig = v >= 2
            val_n = torch.where(
                k != 1, torch.where(vbig, wrap(pre * m + v - 1), wrap(pre * m)), pre
            )
            bits_n = pre + 1 + torch.where(k != 1, torch.where(vbig, k, k - 1), 0)
            value = torch.where(is_esc, val_esc, val_n)
            nbits = torch.where(is_esc, 9 + max_size, bits_n)

            # Signed mapping (golomb.go:206-212), wrapping 32-bit.
            nd = wrap(value + zmode)
            delta = wrap((u(nd + 1) >> 1) * (1 - 2 * (nd & 1)))
            emit = torch.where(dec, delta, torch.where(rawact, sshr(win, 32 - rawcb), 0))
            rows[p, t] = emit.to(torch.int32)

            off = torch.where(rawact, off + rstep, off)
            count = count + (dec | zdrain | rawact).long()
            off = torch.where(dec, wrap(off + nbits), off)
            zrem = torch.where(zdrain, zrem - 1, zrem)

            # Adaptive mean (golomb.go:215-218): uint32 wrap arithmetic.
            pu = u(pbl)
            mean_n = wrap(pu * u(nd) + u(mean) - (((pu * u(mean)) & 0xFFFFFFFF) >> 9))
            mean_n = torch.where(u(value) > 0xFFFF, 0xFFFF, mean_n)
            mean = torch.where(dec, mean_n, mean)
            zmode = torch.where(dec, 0, zmode)

            # Zero-run mode (golomb.go:223-246).
            zc = dec & (u(shl(mean, 2)) < 512) & (count < ns)
            k32 = torch.clamp(clz(mean) - 24 + (u(mean + 16) >> 6), min=0)
            mz = wrap(shl(torch.ones_like(k32), k32) - 1) & wb_mask
            zwin = window32(words, off)
            zpre = clz(wrap(~zwin))
            z_esc = zpre >= 9
            zval_esc = ushr(shl(zwin, 9), 16)
            zv = ushr(shl(zwin, zpre + 1), 32 - k32.clamp(min=1))
            zv = torch.where(k32 == 0, 0, zv)
            zvbig = zv >= 2
            zrun = torch.where(
                z_esc, zval_esc,
                torch.where(zvbig, wrap(zpre * mz + zv - 1), wrap(zpre * mz)),
            )
            zbits = torch.where(z_esc, 25, zpre + 1 + torch.where(zvbig, k32, k32 - 1))
            zover = zc & (wrap(count + zrun) > ns)
            err = torch.where(zover, ERR_SAMPLES, err)
            act = act & ~zover
            zc = zc & ~zover
            zrem = torch.where(zc, zrun, zrem)
            off = torch.where(zc, wrap(off + zbits), off)
            zmode = torch.where(zc, torch.where(zrun >= 65535, 0, 1), zmode)
            mean = torch.where(zc, 0, mean)

            act = act & (count < ns) & (err == ERR_NONE)

    bp_out = torch.where(P["is_comp"], off, bitpos)
    i32 = torch.int32
    return rows, bp_out.to(i32), err.to(i32), wrap(P["meta"]).to(i32)
