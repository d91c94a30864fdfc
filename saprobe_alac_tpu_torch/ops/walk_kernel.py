"""The walk kernels: the element walk, the packet walk and the entropy walk.

`dense_element` is the counterpart of saprobe_alac_tpu/ops/walk_kernel.py
`dense_element_pallas` (`_element_kernel`): SCE/CPE header + coefficient
parse and the two-pass adaptive Golomb-Rice walk, one packet per lane.  It
launches the CUDA kernel (csrc/element_kernel.cu) for CUDA tensors and runs
the plain PyTorch version, `dense_element_reference`, for CPU tensors.  Both
return the quantities the Pallas kernel returns, without its TPU tiling:

    rows (passes, F_pad, B)  residual row t of pass p (U, then V) per lane;
                             the dense emission schedule writes every row,
                             zeros where a lane has nothing to emit
    bitpos (B,)              post-entropy cursor of compressed lanes, else
                             the input cursor
    err (B,)                 ERR_* code
    meta (META_ROWS, B)      parsed element fields, rows M_*

F_pad is F rounded up to 16.  All int32.  Parity: golomb.go:112-253,
decoder.go:210-265/348-460, bitbuffer.go:28-32 (zero reads past the end).
The decode path does not call it: the packet walk below does its work there,
and the tests hold the packet walk's elements against it.

Two more kernels share that parse and walk (csrc/element_walk.cuh):

`dense_packet` (csrc/packet_kernel.cu; plain `dense_packet_reference`) is the
decode path's walk for every C = 1..8: one launch walks every element of
every packet, where the JAX package loops over element slots around
`dense_element_pallas` (saprobe_alac_tpu/ops/walk.py `slot_body_dense`).  It
returns rows (C, F_pad, B), one plane per bitstream channel, err (B,), ns
(B,), the per-channel metadata (len(PACKET_FIELDS), B, C) and coefs
(B, C, 32).

`dense_entropy` (csrc/dense_entropy_kernel.cu; plain
`dense_entropy_reference`) is the counterpart of `dense_entropy_pallas`
(`_dense_kernel`): the walk alone from given cursors with per-lane tuning,
no parse.

The three kernels run one thread a lane, 32 a block (element_walk.cuh
`kThreads`).
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

#: Slots beyond the channel-filling elements, for DSE/FIL/END interleave
#: (saprobe_alac_tpu/ops/walk.py:31).
EXTRA_SLOTS = 4

#: Planes of `dense_packet`'s per-channel metadata, the (B, C) fields of
#: ops/walk.py `WalkResult` in its order.
PACKET_FIELDS = (
    "order", "mode", "den", "cb", "bs", "esc", "esc_base", "esc_cb", "shift_base",
    "mixbits", "mixres", "role", "out_chan", "filled",
)

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


def _check_lanes(kernel, words, named):
    """Every tensor a kernel reads: contiguous int32 on the device of
    ``words`` (B, W), the lane vectors of shape (B,)."""
    B = words.shape[0]
    for name, t in (("words", words), *named):
        if t.device != words.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{kernel} {name}: want contiguous int32 on {words.device}")
        if name != "words" and t.shape != (B,):
            raise ValueError(f"{kernel} {name}: want shape ({B},), got {tuple(t.shape)}")


def _check_kb(kb):
    """kb is the cookie's byte (config.go:27-38): the walk loop takes one
    cursor step a codeword, which holds for 0 <= kb (element_walk.cuh
    `walk_pass`)."""
    if not 0 <= kb <= 255:
        raise ValueError(f"kb must be 0..255, got {kb}")


def dense_element(
    words, bitpos, pact, size_bits, ns_in, allow_cpe,
    *, kb, F, depth, pb_cfg, mb_cfg, passes,
):
    """Run the element kernel over a (B, W) batch of big-endian words.

    CUDA tensors launch the kernel, CPU tensors run the plain version."""
    args = (words, bitpos, pact, size_bits, ns_in, allow_cpe)
    kw = dict(kb=kb, F=F, depth=depth, pb_cfg=pb_cfg, mb_cfg=mb_cfg, passes=passes)
    _check_kb(kb)
    if words.device.type == "cpu":
        return dense_element_reference(*args, **kw)
    if words.device.type != "cuda":
        raise ValueError(f"no element kernel for device {words.device}")
    B, W = words.shape
    names = ("bitpos", "pact", "size_bits", "ns_in", "allow_cpe")
    _check_lanes("dense_element", words, zip(names, args[1:]))
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


def _walk_pass(words, size_bits, out, st, *, raw, rstep, rawcb, max_size, ns, pbl, kb):
    """One pass of the plain walk, vectorised over lanes: row t of the pass
    goes to ``out[t]``.  A loop over the rows: at each step a lane decodes
    one codeword (its window read with torch.gather), drains one zero of a
    pending zero run, reads one raw escape field, or idles and emits 0 — the
    dense emission schedule of walk_kernel.py:401-507.  ``st`` is the carried
    state (act, off, err, count, mean, zmode, zrem), int64 holding int32
    values; every sum that can overflow is wrapped.  ``raw`` is None where
    no lane reads raw fields."""
    act, off, err, count, mean, zmode, zrem = st
    wb_mask = (1 << kb) - 1 if kb < 32 else -1
    for t in range(out.shape[0]):
        if t % 16 == 0 and not bool(act.any()):
            break
        dec = act & (zrem == 0)
        zdrain = act & (zrem > 0)
        if raw is not None:
            dec = dec & ~raw
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
        emit = torch.where(dec, delta, 0)
        stepped = dec | zdrain
        if raw is not None:
            emit = torch.where(rawact, sshr(win, 32 - rawcb), emit)
            off = torch.where(rawact, off + rstep, off)
            stepped = stepped | rawact
        out[t] = emit.to(torch.int32)

        count = count + stepped.long()
        off = torch.where(dec, wrap(off + nbits), off)
        zrem = torch.where(zdrain, zrem - 1, zrem)

        # Adaptive mean (golomb.go:215-218): uint32 wrap arithmetic.
        pu = u(pbl)
        mean_n = wrap(pu * u(nd) + u(mean) - (((pu * u(mean)) & 0xFFFFFFFF) >> 9))
        mean_n = torch.where(u(value) > 0xFFFF, 0xFFFF, mean_n)
        mean = torch.where(dec, mean_n, mean)
        zmode = torch.where(dec, 0, zmode)

        # Zero-run mode (golomb.go:223-246).  A row on which no lane enters
        # it leaves every operand of this block as it was: skipping it there
        # saves two fifths of a row's op launches on music.
        zc = dec & (u(shl(mean, 2)) < 512) & (count < ns)
        if bool(zc.any()):
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
    return act, off, err, count, mean, zmode, zrem


def _fresh(act, off, err, mean):
    """The walk state at the start of a pass: fresh entropy state at cursor
    ``off``."""
    z = torch.zeros_like(off)
    return act, off, err, z, mean, z, z


def dense_element_reference(
    words, bitpos, pact, size_bits, ns_in, allow_cpe,
    *, kb, F, depth, pb_cfg, mb_cfg, passes,
):
    """Plain PyTorch element decode, vectorised over lanes: the parse, then
    `_walk_pass` for U and for V."""
    L = torch.int64
    B = words.shape[0]
    bitpos, size_bits, ns_in = bitpos.to(L), size_bits.to(L), ns_in.to(L)
    P = _parse(words, bitpos, pact != 0, size_bits, ns_in, allow_cpe != 0, F, depth)
    ns = P["ns"]
    raw = P["is_escape"]
    lane = dict(
        raw=raw, rstep=P["nch"] * P["esc_cb"], rawcb=P["esc_cb"].clamp(min=1),
        max_size=P["cb_comp"], ns=ns, kb=kb,
    )
    mean0 = torch.full_like(bitpos, mb_cfg)
    live = (P["is_comp"] | raw) & (ns > 0)

    rows = torch.zeros((passes, f_pad(F), B), dtype=torch.int32, device=words.device)
    st = _fresh(live, torch.where(raw, P["esc_base"], P["p_ent"]), P["err"], mean0)
    st = _walk_pass(words, size_bits, rows[0], st, pbl=(pb_cfg * P["pbf_u"]) >> 2, **lane)
    if passes == 2:
        # Channel switch: V lanes restart at U's end cursor with fresh state
        # and the V tuning; escape lanes rewind to the V phase of the
        # interleaved raw region (walk_kernel.py:573-597).
        _, off, err = st[:3]
        st = _fresh(
            P["is_cpe"] & live & (err == ERR_NONE),
            torch.where(raw, P["esc_base"] + P["esc_cb"], off), err, mean0,
        )
        st = _walk_pass(words, size_bits, rows[1], st, pbl=(pb_cfg * P["pbf_v"]) >> 2, **lane)
    _, off, err = st[:3]
    bp_out = torch.where(P["is_comp"], off, bitpos)
    i32 = torch.int32
    return rows, bp_out.to(i32), err.to(i32), wrap(P["meta"]).to(i32)


def dense_entropy(
    words, bitpos, act, pb, max_size, ns, size_bits, mb, act2=None, pb2=None,
    *, kb, F, passes=1,
):
    """The entropy walk alone over a (B, W) batch of big-endian words, from
    per-lane cursors ``bitpos`` with per-lane tuning (``pb``, ``max_size``
    the escape suffix width, ``mb``), for the lanes of ``act`` with
    ``ns > 0``.  With ``passes=2`` the lanes of ``act2`` (and ``ns > 0``)
    that ended pass 1 without an error walk a second channel from their
    pass-1 end cursor with fresh entropy state and ``pb2``.

    Returns (rows (passes, F_pad, B), bitpos' (B,), err (B,)), int32:
    every row written, zeros where a lane is idle; ``bitpos'`` is the end
    cursor on the lanes of ``act`` and the input cursor elsewhere.  CUDA
    tensors launch the kernel, CPU tensors run the plain version."""
    if passes not in (1, 2):
        raise ValueError(f"passes must be 1 or 2, got {passes}")
    _check_kb(kb)
    act2 = torch.zeros_like(act) if act2 is None else act2
    pb2 = torch.zeros_like(pb) if pb2 is None else pb2
    lane = (bitpos, act, pb, max_size, ns, size_bits, mb, act2, pb2)
    if words.device.type == "cpu":
        return dense_entropy_reference(words, *lane, kb=kb, F=F, passes=passes)
    if words.device.type != "cuda":
        raise ValueError(f"no dense entropy kernel for device {words.device}")
    names = ("bitpos", "act", "pb", "max_size", "ns", "size_bits", "mb", "act2", "pb2")
    _check_lanes("dense_entropy", words, zip(names, lane))
    B, W = words.shape
    Fp = f_pad(F)
    dev = words.device
    rows = torch.empty((passes, Fp, B), dtype=torch.int32, device=dev)
    bp_out = torch.empty(B, dtype=torch.int32, device=dev)
    err = torch.empty(B, dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.alac_dense_entropy_launch(
            words.data_ptr(), W, *(t.data_ptr() for t in lane), rows.data_ptr(),
            bp_out.data_ptr(), err.data_ptr(), B, Fp, passes, kb, stream,
        )
    if rc != 0:
        raise RuntimeError(f"dense entropy kernel launch failed: CUDA error {rc}")
    _build.count_launch("dense_entropy")
    return rows, bp_out, err


def dense_entropy_reference(
    words, bitpos, act, pb, max_size, ns, size_bits, mb, act2=None, pb2=None,
    *, kb, F, passes=1,
):
    """Plain PyTorch `dense_entropy`: `_walk_pass` once per pass."""
    L = torch.int64
    B = words.shape[0]
    bitpos, ns, size_bits, mb = (x.to(L) for x in (bitpos, ns, size_bits, mb))
    lane = dict(raw=None, rstep=None, rawcb=None, max_size=max_size.to(L), ns=ns, kb=kb)
    rows = torch.zeros((passes, f_pad(F), B), dtype=torch.int32, device=words.device)
    act0 = act != 0
    st = _fresh(act0 & (ns > 0), bitpos, torch.zeros_like(bitpos), mb)
    st = _walk_pass(words, size_bits, rows[0], st, pbl=pb.to(L), **lane)
    if passes == 2:
        _, off, err = st[:3]
        st = _fresh((act2 != 0) & (ns > 0) & (err == ERR_NONE), off, err, mb)
        st = _walk_pass(words, size_bits, rows[1], st, pbl=pb2.to(L), **lane)
    _, off, err = st[:3]
    i32 = torch.int32
    return rows, torch.where(act0, off, bitpos).to(i32), err.to(i32)


def dense_packet(words, size_bits, offsets, *, kb, F, C, depth, pb_cfg, mb_cfg):
    """Walk every element of every packet of a (B, W) batch of big-endian
    words in one launch.  ``offsets`` (C,) maps a bitstream channel to its
    output channel (encoder/spec.py CHANNEL_LAYOUT_OFFSETS).

    Returns (rows (C, F_pad, B), err (B,), ns (B,), meta
    (len(PACKET_FIELDS), B, C), coefs (B, C, 32)), int32.  Channels no
    element reached are all-zero with ``filled`` 0.  CUDA tensors launch the
    kernel, CPU tensors run the plain version."""
    kw = dict(kb=kb, F=F, C=C, depth=depth, pb_cfg=pb_cfg, mb_cfg=mb_cfg)
    _check_kb(kb)
    if words.device.type == "cpu":
        return dense_packet_reference(words, size_bits, offsets, **kw)
    if words.device.type != "cuda":
        raise ValueError(f"no packet kernel for device {words.device}")
    _check_lanes("dense_packet", words, [("size_bits", size_bits)])
    if (offsets.device != words.device or offsets.dtype != torch.int32
            or offsets.shape != (C,) or not offsets.is_contiguous()):
        raise ValueError(f"dense_packet offsets: want contiguous int32 ({C},) on {words.device}")
    if not 1 <= C <= 8:
        raise ValueError(f"C must be 1..8, got {C}")
    B, W = words.shape
    Fp = f_pad(F)
    dev = words.device
    i32 = torch.int32
    rows = torch.empty((C, Fp, B), dtype=i32, device=dev)
    err = torch.empty(B, dtype=i32, device=dev)
    ns = torch.empty(B, dtype=i32, device=dev)
    meta = torch.empty((len(PACKET_FIELDS), B, C), dtype=i32, device=dev)
    coefs = torch.empty((B, C, 32), dtype=i32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.alac_packet_launch(
            words.data_ptr(), W, size_bits.data_ptr(), offsets.data_ptr(), rows.data_ptr(),
            err.data_ptr(), ns.data_ptr(), meta.data_ptr(), coefs.data_ptr(),
            B, C, F, Fp, kb, depth, pb_cfg, mb_cfg, stream,
        )
    if rc != 0:
        raise RuntimeError(f"packet kernel launch failed: CUDA error {rc}")
    _build.count_launch("packet")
    return rows, err, ns, meta, coefs


def dense_packet_reference(words, size_bits, offsets, *, kb, F, C, depth, pb_cfg, mb_cfg):
    """Plain PyTorch `dense_packet`: a slot loop over
    `dense_element_reference`, every lane at its own element each slot, as
    the JAX package's `slot_body_dense` (walk.py:799-1073) and the commit
    after its loop (:1150-1159): the element's rows go to plane ``chan`` (and
    ``chan + 1``), its metadata to column ``chan``, DSE and FIL elements are
    skipped, and a lane ends at END, at an error, when its channels are full
    or after C + EXTRA_SLOTS elements (ERR_SLOTS)."""
    L = torch.int64
    i32 = torch.int32
    B = words.shape[0]
    dev = words.device
    size_bits = size_bits.to(L)
    offsets = offsets.to(L)
    passes = 2 if C > 1 else 1
    z = torch.zeros(B, dtype=L, device=dev)
    bitpos, chan, err, ns = z, z, z, z + F
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    rows = torch.zeros((C, f_pad(F), B), dtype=i32, device=dev)
    meta = {name: torch.zeros((B, C), dtype=L, device=dev) for name in PACKET_FIELDS}
    coefs = torch.zeros((B, C, 32), dtype=L, device=dev)
    cols = torch.arange(C, device=dev)[None, :]

    def past_end(pos):
        return (pos >> 3) >= (size_bits >> 3)

    for _ in range(C + EXTRA_SLOTS):
        active = ~done & (err == ERR_NONE)
        if not bool(active.any()):
            break
        # Past-end check before the tag read (decoder.go:143-145).
        over = active & past_end(bitpos)
        err = torch.where(over, ERR_OVERRUN, err)
        active = active & ~over
        allow_cpe = chan + 2 <= C
        r, bp2, kerr, m = dense_element_reference(
            words, bitpos.to(i32), active.to(i32), size_bits.to(i32), ns.to(i32),
            allow_cpe.to(i32), kb=kb, F=F, depth=depth, pb_cfg=pb_cfg, mb_cfg=mb_cfg,
            passes=passes,
        )
        m = m.to(L)
        err = torch.where(active & (kerr != ERR_NONE), kerr.to(L), err)
        is_sce = active & (m[M_SCE] == 1)
        is_cpe = active & (m[M_CPE] == 1)
        is_comp = active & (m[M_COMP] == 1)
        is_escape = active & (m[M_ESC] == 1)
        is_elem = is_sce | is_cpe
        tag = m[M_TAG]

        # Rows: U into plane chan, V into plane chan + 1.
        act_u = is_comp | is_escape
        for c in range(C):
            rows[c] = torch.where(act_u & (chan == c), r[0], rows[c])
            if passes == 2:
                rows[c] = torch.where(act_u & is_cpe & (chan + 1 == c), r[1], rows[c])

        # Cursor: past the entropy data, the raw escape data, or the skip.
        nbp = torch.where(is_comp, bp2.to(L), bitpos)
        nbp = torch.where(is_escape, m[M_ESC_END], nbp)
        p0 = bitpos + 3
        # DSE (decoder.go:554-574): align flag, count 255 adds a byte.
        d_cnt = vread(words, p0 + 5, 8)
        d_has2 = d_cnt == 255
        p_dse = p0 + 13 + torch.where(d_has2, 8, 0)
        p_dse = torch.where(vread(words, p0 + 4, 1) == 1, (p_dse + 7) & ~7, p_dse)
        p_dse = p_dse + (d_cnt + torch.where(d_has2, vread(words, p0 + 13, 8), 0)) * 8
        # FIL (decoder.go:538-551): count 15 adds a byte, less one.
        f_cnt = vread(words, p0, 4)
        f_has2 = f_cnt == 15
        f_total = f_cnt + torch.where(f_has2, vread(words, p0 + 4, 8) - 1, 0)
        p_fil = p0 + 4 + torch.where(f_has2, 8, 0) + f_total * 8
        for is_skip, p_skip in ((active & (tag == 4), p_dse), (active & (tag == 6), p_fil)):
            err = torch.where(is_skip & past_end(p_skip), ERR_OVERRUN, err)
            nbp = torch.where(is_skip & (err == ERR_NONE), p_skip, nbp)

        # Per-channel metadata into column chan (and chan + 1 for V).
        bsf = m[M_BSF]
        esc_cb = torch.where(is_cpe, depth, depth - bsf * 8)
        cb = torch.where(is_comp, depth - bsf * 8 + is_cpe.long(), esc_cb)
        pair_comp = is_cpe & is_comp
        out_u = offsets[chan.clamp(0, C - 1)]
        at_u = is_elem[:, None] & (cols == chan[:, None])
        at_v = is_cpe[:, None] & (cols == chan[:, None] + 1)

        def comp(x):
            return torch.where(is_comp, x, 0)

        def put(name, u_val, v_val=None):
            v_val = u_val if v_val is None else v_val
            x = torch.where(at_u, u_val[:, None], meta[name])
            meta[name] = torch.where(at_v, v_val[:, None], x)

        one = torch.ones_like(z)
        put("order", comp(m[M_NUM_U]), comp(m[M_NUM_V]))
        put("mode", comp(m[M_MODE_U]), comp(m[M_MODE_V]))
        put("den", comp(m[M_DEN_U]), comp(m[M_DEN_V]))
        put("cb", cb)
        put("bs", comp(bsf))
        put("esc", is_escape.long())
        put("esc_base", m[M_ESC_BASE])
        put("esc_cb", esc_cb)
        put("shift_base", m[M_SHIFT_BASE])
        put("mixbits", torch.where(pair_comp, m[M_MIXBITS], 0))
        put("mixres", torch.where(pair_comp, m[M_MIXRES], 0))
        put("role", is_cpe.long(), 2 * one)
        put("out_chan", out_u, out_u + 1)
        put("filled", one)
        cu = torch.where(is_comp[:, None], m[M_COEFS_U:M_COEFS_U + 32].T, 0)
        cv = torch.where(is_comp[:, None], m[M_COEFS_V:M_COEFS_V + 32].T, 0)
        coefs = torch.where(at_u[:, :, None], cu[:, None, :], coefs)
        coefs = torch.where(at_v[:, :, None], cv[:, None, :], coefs)

        # A pair tag with one channel left ends the packet without an error.
        cpe_break = active & (tag == 1) & ~allow_cpe
        ns = torch.where(is_elem, m[M_NS], ns)
        chan = chan + is_sce.long() + 2 * is_cpe.long()
        done = done | (active & (tag == 7)) | cpe_break | (chan >= C)
        bitpos = nbp

    # Lanes the budget left unfinished: past the end, on END, or out of slots.
    active = ~done & (err == ERR_NONE)
    over = active & past_end(bitpos)
    err = torch.where(over, ERR_OVERRUN, err)
    done = done | (active & ~over & (vread(words, bitpos, 3) == 7))
    err = torch.where(~done & (err == ERR_NONE), ERR_SLOTS, err)
    packed = wrap(torch.stack([meta[name] for name in PACKET_FIELDS]))
    # torch.where hands on the strides of a transposed operand: the kernel's
    # outputs are contiguous, so these are too.
    return rows, err.to(i32), ns.to(i32), packed.to(i32), wrap(coefs).to(i32).contiguous()
