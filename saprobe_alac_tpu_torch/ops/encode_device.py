"""Device-side ALAC encoding: one packet per lane.

Counterpart of saprobe_alac_tpu/ops/encode_device.py.  The encode direction
is bit-serial per packet (adaptive entropy state) and parallel across
packets, as decode is: a forward LPC over (packet, channel) lanes produces
residuals (`_lpc_forward`, one forward LPC kernel launch for all the
channels of an element, orders 1..30), each channel's residuals are
entropy-coded into a body at bit 0
(`_entropy_bodies`, one encode kernel launch for all the channels of an
element under all its pbFactor candidates), and plain PyTorch assembles headers,
shift regions, bodies and the verbatim (escape) variant into packets.  On a
CUDA tensor the two kernels run; on a CPU tensor their plain versions;
nothing else selects.

Bit emission: output words start zeroed and every emitted bit is new, so
appending is an add (add == or into zeros) and whole zero-tailed buffers can
be added into a packet at a per-lane bit offset.

Scope, as the JAX package's: per-element spec overrides, mode > 0, per-lane
adaptive pbFactor candidates, forced and automatic escape, per-lane
Levinson-Durbin coefficient fitting (float32 on the device), byte shifting,
partial frames, every layout C = 1..8.  With the same coefficients the
packets are bit-identical to the host encoders'; kb == 0 streams go to the
host encoder.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from .. import native
from ..config import PacketConfig
from ..encoder.spec import CHANNEL_LAYOUT_OFFSETS, LFE_BITSTREAM_IDX, EncoderSpec, element_layout
from .batch import _bucket
from .encode_kernel import _emit, dense_encode
from .lpc import _INT32_ORDERS
from .lpc_kernel import lpc_fir
from .torchint import sext, sshr, u, wrap
from .walk_kernel import f_pad

_M32 = 0xFFFFFFFF
I32, I64 = torch.int32, torch.int64

#: Set to a list, it collects what the path hands its kernels and its walk:
#: ("lpc_forward" | "encode" | "encode_walk", positional arguments, keyword
#: arguments) per call, so a check can hold each kernel to its plain version
#: on exactly the main path's inputs.  None (the default) collects nothing.
_calls = None


def _note(name, args, kw):
    if _calls is not None:
        _calls.append((name, args, kw))


def _zero_run_table(res, ns):
    """zrun[i] = consecutive zeros at i (within [0, ns)); (L, F) int32."""
    F = res.shape[1]
    idx = torch.arange(F, dtype=I32, device=res.device)[None, :]
    ns = ns.to(I32)[:, None]
    nonzero = (res != 0) & (idx < ns)
    # Next nonzero position at or after i (ns when none): a reverse cummin.
    pos = torch.where(nonzero, idx, ns)
    nxt = torch.cummin(pos.flip(1), dim=1).values.flip(1)
    return (nxt - idx).clamp(min=0)


def _delta_post(res, cb):
    """The mode > 0 delta of residual rows: d[0] = res[0], d[t] =
    sext(res[t] - res[t-1]) (the decoder un-deltas first, decoder.go:307-309)."""
    r = res.to(I64)
    d = sext(wrap(r[:, 1:] - r[:, :-1]), cb)
    return torch.cat([r[:, :1], d], dim=1).to(I32)


def _lpc_forward_args(chans, order, den_shift, cb, ns, coefs, F, mode):
    """The forward LPC kernel's inputs for the channels of one element, of
    orders 1..30: (`lpc_fir` positional arguments, taps).  Rows (nch, F_pad,
    B), lanes channel-major (lane = c*B + b), as the decode direction reads
    the walk's rows; every lane is class 1; 9 taps serve orders up to 8."""
    nch, B = len(chans), chans[0].shape[0]
    dev = chans[0].device
    rows = torch.zeros((nch, f_pad(F), B), dtype=I32, device=dev)
    for c, d in enumerate(chans):
        rows[c, :F] = d.T
    ones = torch.ones(nch * B, dtype=I32, device=dev)
    taps = 9 if order <= 8 else 32
    args = (
        rows, ones, ones * order, ones * den_shift, ones * cb, ns.to(I32).repeat(nch),
        ones * int(order not in _INT32_ORDERS), ones * int(mode != 0),
        torch.cat([cf[:, :taps] for cf in coefs]).to(I32),
    )
    return args, taps


def _lpc_forward(chans, order, den_shift, cb, ns, coefs, F, mode):
    """Forward LPC residuals for the channels of one element, the mode
    post-pass included: one (B, F) int32 array per channel.

    chans: (B, F) int32 per channel; coefs: (B, 32) int32 per channel.
    Orders 1..30 run the forward LPC kernel (ops/lpc_kernel.py,
    forward=True) once for all the element's channels, which also runs the
    mode post-pass; orders 0 and 31 have no serial recurrence and are tensor
    ops.  Rows at t >= ns are don't-care."""
    if 1 <= order <= 30:
        args, taps = _lpc_forward_args(chans, order, den_shift, cb, ns, coefs, F, mode)
        _note("lpc_forward", args, dict(F=F, taps=taps, forward=True))
        res = lpc_fir(*args, F=F, taps=taps, forward=True)[:F]
        B = chans[0].shape[0]
        return [res[:, c * B : (c + 1) * B].T.contiguous() for c in range(len(chans))]
    # Order 0: the residuals are the samples; order 31: first differences.
    out = []
    for d in chans:
        res = d if order == 0 else _delta_post(d, cb)
        out.append(_delta_post(res, cb) if mode != 0 else res)
    return out


def _entropy_args(res, ns, pb_local, cb, mb):
    """The encode kernel's inputs for residual rows (B, F), one lane a row:
    `dense_encode` positional arguments (n_t and zr1_t (F, B), act,
    pb_local, max_size, ns, mb), every lane active."""
    B = res.shape[0]
    zrun = _zero_run_table(res, ns)
    r = res.to(I64)
    n = wrap(torch.where(r >= 0, 2 * r, -2 * r - 1)).to(I32)  # zigzag, wrapping
    zr1 = torch.cat([zrun[:, 1:].clamp(max=65535), zrun.new_zeros((B, 1))], dim=1)
    full = torch.ones(B, dtype=I32, device=res.device)
    return (n.T.contiguous(), zr1.T.contiguous(), full, pb_local.to(I32), full * cb,
            ns.to(I32), full * mb)


def _element_entropy_args(res_list, ns, pb_locals, cb, mb):
    """The encode kernel's inputs for every channel of an element under
    every pbFactor candidate, one launch: (`dense_encode` positional
    arguments, row map).  Rows (F, nch*B) channel-major; lanes
    candidate-major, then channel (lane (p*nch + c)*B + b codes row c*B + b
    with ``pb_locals[p]``)."""
    nch, B = len(res_list), res_list[0].shape[0]
    P = len(pb_locals)
    n_t, zr_t, act, _, max_size, ns_l, mb_l = _entropy_args(
        torch.cat(res_list), ns.repeat(nch), pb_locals[0].repeat(nch), cb, mb)
    pb = torch.cat([pbl.to(I32).repeat(nch) for pbl in pb_locals])
    row = torch.arange(nch * B, dtype=I32, device=n_t.device).repeat(P)
    act, max_size, ns_l, mb_l = (x.repeat(P) for x in (act, max_size, ns_l, mb_l))
    return (n_t, zr_t, act, pb, max_size, ns_l, mb_l), row


def _entropy_bodies(res_list, ns, pb_cands, pb, cb, mb, kb, F, Wch):
    """Entropy-encode the channels of one element, each under every
    pbFactor candidate, in one encode kernel launch; the smallest body wins
    per (lane, channel), ties keeping the earlier candidate.  Returns per
    channel (buf (B, Wch) int32 at bit 0, big-endian bit order, bits (B,),
    chosen pbFactor (B,)) and the lanes that overflowed a row (B,)."""
    nch, B = len(res_list), res_list[0].shape[0]
    dev = res_list[0].device
    pb_locals = [torch.full((B,), (pb * pbf) // 4, dtype=I64, device=dev) for pbf in pb_cands]
    args, row = _element_entropy_args(res_list, ns, pb_locals, cb, mb)
    kw = dict(kb=kb, F=F, W_out=Wch, row=row)
    _note("encode", args, kw)
    buf, bits, ovf = dense_encode(*args, **kw)
    P = len(pb_cands)
    buf = buf.view(P, nch, B, Wch)
    bits = bits.to(I64).view(P, nch, B)
    ovf_any = (ovf != 0).view(P * nch, B).any(dim=0)
    bodies = []
    for c in range(nch):
        best = (buf[0, c], bits[0, c], torch.full((B,), pb_cands[0], dtype=I64, device=dev))
        for p in range(1, P):
            better = bits[p, c] < best[1]
            best = (
                torch.where(better[:, None], buf[p, c], best[0]),
                torch.where(better, bits[p, c], best[1]),
                torch.where(better, pb_cands[p], best[2]),
            )
        bodies.append(best)
    return bodies, ovf_any


def _pack_fields(values, width):
    """Dense MSB-first pack of K ``width``-bit fields at bit 0: (B, K) ->
    (B, ceil(K*width/32)) int32 big-endian words.  Field k starts at bit
    k*width in every lane, so two index_adds with shared indices do it."""
    B, K = values.shape
    dev = values.device
    Wd = (K * width + 31) // 32
    off = torch.arange(K, device=dev) * width
    win = (u(values) & ((1 << width) - 1)) << (64 - (off & 31) - width)[None, :]
    out = torch.zeros((B, Wd + 1), dtype=I32, device=dev)
    out.index_add_(1, off >> 5, wrap((win >> 32) & _M32).to(I32))
    out.index_add_(1, (off >> 5) + 1, wrap(win & _M32).to(I32))
    return out[:, :Wd]


def _blit_bits(words, base, src):
    """Add ``src`` (B, Ws) int32 big-endian words into ``words`` at per-lane
    bit offset ``base``, in place.  The source is funnel-shifted by
    base & 31 and gathered to word base >> 5; bits landing beyond the
    destination are dropped (call sites only ever blit zero tails there)."""
    W = words.shape[1]
    Ws = src.shape[1]
    q = (base >> 5)[:, None]
    r = (base & 31)[:, None]
    s = u(src)
    pad = s.new_zeros((s.shape[0], 1))
    shifted = (torch.cat([s, pad], 1) >> r) | ((torch.cat([pad, s], 1) << (32 - r)) & _M32)
    idx = torch.arange(W, device=words.device)[None, :] - q
    got = wrap(shifted).to(I32).gather(1, idx.clamp(0, Ws))
    words += torch.where((idx >= 0) & (idx <= Ws), got, 0)


def _emit_many(words, base, values, width):
    """Append K fixed-width fields per lane starting at ``base`` (in place);
    returns base + K*width."""
    _blit_bits(words, base, values if width == 32 else _pack_fields(values, width))
    return base + values.shape[1] * width


def fit_coefs(d, ns, order, den_shift, shared):
    """Per-lane Levinson-Durbin on the post-mix channel data, float32 on the
    device; mirrors native/alac_encode.cpp fit_coefs and falls back to the
    ``shared`` coefficients on degenerate lanes.  Any coefficients are valid
    (the adaptive decoder walks from them), so rounding, which depends on
    the order of the float32 sums, moves compression and never
    losslessness.  d: (B, F) int32; returns (B, 32) int32."""
    B, F = d.shape
    f32 = torch.float32
    valid = torch.arange(F, device=d.device)[None, :] < ns[:, None]
    x = torch.where(valid, d, 0).to(f32) * (1.0 / 32768.0)
    mean = x.sum(1, keepdim=True) / ns[:, None].clamp(min=1).to(f32)
    x = torch.where(valid, x - mean, 0.0)
    R = [(x * x).sum(1) * (1.0 + 1e-9) + 1e-30]
    for k in range(1, order + 1):
        R.append((x[:, k:] * x[:, : F - k]).sum(1))
    a = [torch.zeros(B, dtype=f32, device=d.device) for _ in range(order + 1)]
    err = R[0]
    ok = R[0] > 1e-20
    for i in range(1, order + 1):
        acc = R[i]
        for j in range(1, i):
            acc = acc - a[j] * R[i - j]
        k_ref = (acc / err).clamp(-0.999, 0.999)
        prev = list(a)
        a[i] = k_ref
        for j in range(1, i):
            a[j] = prev[j] - k_ref * prev[i - j]
        err = err * (1.0 - k_ref * k_ref)
        ok = ok & (err > 0.0)
    fitted = torch.zeros((B, 32), dtype=I32, device=d.device)
    for k in range(order):
        fitted[:, k] = torch.round(a[k + 1] * float(1 << den_shift)).clamp(-30000, 30000).to(I32)
    use = ok & (ns >= 4 * order + 8)
    return torch.where(use[:, None], fitted, shared)


def _mix_pair(h0, h1, mr, mix_bits_s, cb, valid):
    """Decorrelate a channel pair, the inverse of unmix in wrapping int32:
    v = l - r; u = r + ((mix_res * v) >> mix_bits).  Decorrelated values must
    fit ``cb`` bits (the decoder sign-extends), else the lane keeps
    independent channels.  Returns ([u, v] (B, F) int32, the mix_res used)."""
    h0, h1 = h0.to(I64), h1.to(I64)
    v_mix = wrap(h0 - h1)
    u_mix = wrap(h1 + sshr(wrap(mr[:, None] * v_mix), mix_bits_s))
    lim = 1 << (cb - 1)
    out = (u_mix >= lim) | (u_mix < -lim) | (v_mix >= lim) | (v_mix < -lim)
    mr = torch.where((valid & out).any(dim=1), 0, mr)
    mixed = (mr != 0)[:, None]
    return [torch.where(mixed, u_mix, h0).to(I32), torch.where(mixed, v_mix, h1).to(I32)], mr


def _bounds(elem_spec, width_e, F, depth, kb, bs, any_escape):
    """Worst-case sizes of one element: (bits per sample of a channel body,
    compressed bits, verbatim bits, bits of the chosen variant).  One coded
    sample is a prefix <= 9 plus a suffix <= max(kb, chanBits) and one
    zero-run code (<= 9 + 16); the verbatim variant is exactly header +
    ns*nch*depth bits, and whenever escape is a candidate the chosen element
    is no larger than that."""
    order_e = elem_spec[0]
    nch_e = 2 if width_e == 2 else 1
    bs_el = max(bs, 1) if (width_e == 2 and depth == 32) else bs
    cb_e = depth - bs_el * 8 + (1 if width_e == 2 else 0)
    bps = 9 + max(kb, cb_e) + 26
    hdr = 64
    esc_bits = hdr + F * nch_e * depth
    comp_bits = (hdr + 16 + nch_e * (24 + 16 * order_e)
                 + F * nch_e * 8 * bs_el + F * nch_e * bps)
    chosen_bits = esc_bits if any_escape else max(esc_bits, comp_bits)
    return bps, comp_bits, esc_bits, chosen_bits


def encode_walk(
    planes,  # (B, C, F) int32, SMPTE channel order
    ns,  # (B,) samples per packet
    mix_res,  # (B,) per-packet mix_res (0 disables decorrelation)
    coefs_in,  # (E, 32) int32 shared initial coefficients per element
    *, frame_length, num_channels, depth, pb, mb, kb,
    elem_specs,  # per element (order, den_shift, pb_candidates, mode, fit)
    mix_bits_s, bytes_shifted, use_lfe_tag, force_escape, auto_escape,
):
    """Packet assembly on the device: (words (B, W) int32 big-endian bit
    order, bits (B,), ovf (B,)).  ``ovf`` marks lanes whose channel body
    outgrew its row; the rows hold the worst case of `_bounds`, so it is set
    only if that sizing is wrong, and `encode_packets_device` raises on it.

    Each element is assembled in scratch buffers of its own, a compressed
    variant and a verbatim (escape) one; the escape is taken when the
    residuals are uncodable, when forced, or (auto_escape) when it is
    smaller, and the chosen buffer is added into the packet at the lane's
    bit position: trailing zero words add nothing, and later emissions into
    the same region are adds too, so no masking is needed.  With several
    pb_candidates each channel is entropy-coded once per candidate (one
    launch for them all) and the smallest wins per lane (ties keep the
    earlier one)."""
    F, C = frame_length, num_channels
    B = planes.shape[0]
    dev = planes.device
    layout = element_layout(C)
    if len(elem_specs) != len(layout):
        raise ValueError(f"{len(elem_specs)} element specs for {len(layout)} elements")
    offsets = CHANNEL_LAYOUT_OFFSETS[C - 1]
    bs = bytes_shifted if depth >= 24 else 0
    lfe_idx = LFE_BITSTREAM_IDX.get(C, -1)
    ns = ns.to(I64)
    mix_res = mix_res.to(I64)
    idxF = torch.arange(F, device=dev)[None, :]
    validF = idxF < ns[:, None]

    bounds = [
        _bounds(es, w_e, F, depth, kb, bs, force_escape or auto_escape)
        for es, w_e in zip(elem_specs, layout)
    ]
    W = (sum(b[3] for b in bounds) + 16) // 32 + 4
    words = torch.zeros((B, W), dtype=I32, device=dev)
    bitpos = torch.zeros(B, dtype=I64, device=dev)
    ovf_any = torch.zeros(B, dtype=torch.bool, device=dev)
    partial_f = ns != F

    def const(v):
        return torch.full((B,), v, dtype=I64, device=dev)

    def emit_hdr(buf, pos, tag, bs_field, escape_flag):
        """The common element header into a scratch buffer."""
        pos = _emit(buf, pos, const(tag), const(3))
        pos = _emit(buf, pos, const(0), const(16))  # instance tag, 12 unused bits
        hdr4 = torch.where(partial_f, 8, 0) + (bs_field << 1) + escape_flag
        pos = _emit(buf, pos, hdr4, const(4))
        pw = torch.where(partial_f, 16, 0)
        pos = _emit(buf, pos, ns >> 16, pw)
        return _emit(buf, pos, ns & 0xFFFF, pw)

    def interleaved(chans):
        """(B, nch*F) samples in packet order, zero past each lane's ns."""
        v = torch.stack(chans, dim=2) if len(chans) > 1 else chans[0][:, :, None]
        return torch.where(validF[:, :, None], v, 0).reshape(B, -1)

    chan = 0
    for ei, width_e in enumerate(layout):
        order, den_shift, pb_cands, mode, fit = elem_specs[ei]
        pair = width_e == 2
        nch = 2 if pair else 1
        bs_e = max(bs, 1) if (pair and depth == 32) else bs  # avoid chanBits = 33
        cb = depth - bs_e * 8 + (1 if pair else 0)
        shift_w = bs_e * 8
        tag = 3 if (use_lfe_tag and chan == lfe_idx) else (1 if pair else 0)
        bps_e, comp_bits, _, _ = bounds[ei]

        # --- channel data: split the shift lows, mix pairs ---
        raw = [planes[:, offsets[chan] + c] for c in range(nch)]
        high = [sshr(c, shift_w) for c in raw] if bs_e else raw
        low = [c & ((1 << shift_w) - 1) for c in raw] if bs_e else None
        if pair:
            ch_data, mr = _mix_pair(*high, mix_res, mix_bits_s, cb, validF)
        else:
            ch_data, mr = high, const(0)

        # --- per-channel coefficients and residuals, the uncodable gate ---
        shared_c = coefs_in[ei][None, :].expand(B, 32).to(I32)
        if fit and 1 <= order <= 30:
            ch_coefs = [fit_coefs(d, ns, order, den_shift, shared_c) for d in ch_data]
        else:
            ch_coefs = [shared_c] * nch
        bad = torch.zeros(B, dtype=torch.bool, device=dev)
        res_list = _lpc_forward(ch_data, order, den_shift, cb, ns, ch_coefs, F, mode)
        for res in res_list:
            if cb >= 32:
                # A residual of INT32_MIN maps to 2^32 - 1, which the decoder
                # wraps to 0: such a lane takes the verbatim element.
                bad |= (validF & (res == -(1 << 31))).any(dim=1)

        # --- compressed variant (scratch): headers, shift region, bodies ---
        # Each channel body is coded at bit 0 of a buffer of its own, under
        # every pbFactor candidate, all in one launch; the smallest wins per lane.
        Wch = (F * bps_e + 256) // 32 + 4
        bodies, ovf = _entropy_bodies(res_list, ns, pb_cands, pb, cb, mb, kb, F, Wch)
        ovf_any |= ovf
        del res_list

        Ws = (comp_bits + 31) // 32 + 4
        sc = torch.zeros((B, Ws), dtype=I32, device=dev)
        sp = emit_hdr(sc, torch.zeros_like(bitpos), tag, bs_e, 0)
        sp = _emit(sc, sp, torch.where(mr != 0, mix_bits_s, 0), const(8))
        sp = _emit(sc, sp, mr & 0xFF, const(8))
        for ci in range(nch):
            sp = _emit(sc, sp, const((mode << 4) | den_shift), const(8))
            sp = _emit(sc, sp, (bodies[ci][2] << 5) | order, const(8))
            for kcoef in range(order):
                sp = _emit(sc, sp, ch_coefs[ci][:, kcoef].to(I64) & 0xFFFF, const(16))
        if bs_e:
            _emit_many(sc, sp, interleaved(low), shift_w)
            sp = sp + ns * nch * shift_w
        for buf, blen, _ in bodies:
            _blit_bits(sc, sp, buf)  # zero tail words add nothing
            sp = sp + blen
        del bodies

        # --- escape (verbatim) variant (scratch) ---
        We = (F * nch * depth + 256) // 32 + 4
        se = torch.zeros((B, We), dtype=I32, device=dev)
        sep = emit_hdr(se, torch.zeros_like(bitpos), tag, 0, 1)
        _emit_many(se, sep, interleaved(raw), depth)
        sep = sep + ns * nch * depth

        # --- choose, and add into the packet ---
        if force_escape:
            use_esc = torch.ones_like(bad)
        elif auto_escape:
            use_esc = bad | (sep < sp)
        else:
            use_esc = bad
        Wmax = max(Ws, We)
        chosen = torch.where(
            use_esc[:, None], tF.pad(se, (0, Wmax - We)), tF.pad(sc, (0, Wmax - Ws))
        )
        del sc, se
        _blit_bits(words, bitpos, chosen)
        bitpos = bitpos + torch.where(use_esc, sep, sp)
        chan += nch

    # END tag and byte align
    bitpos = _emit(words, bitpos, const(7), const(3))
    bitpos = _emit(words, bitpos, const(0), (8 - (bitpos & 7)) & 7)
    return words, bitpos, ovf_any


def encode_packets_device(config: PacketConfig, spec: EncoderSpec, pcm_list,
                          device="cuda") -> list[bytes]:
    """Encode packets on ``device`` (the card unless the caller asks for
    ``"cpu"``, which runs the kernels' plain versions); bit-identical to the
    host encoders given the same coefficients.

    ``pcm_list``: (ns_i, C) integer arrays, one per packet.  Lanes whose
    residuals are uncodable at 32-bit width emit the verbatim element, as
    the host encoders do.  With ``fit`` on and no pinned coefficients each
    lane's channels are fitted on the device; the shared fallback for
    degenerate lanes is `initial_coefs` of the first packet.  kb == 0
    streams go to the host encoder (`native.encode_with_spec`); nothing
    else does: a lane that overflows its row raises RuntimeError."""
    if not pcm_list:
        return []
    if config.kb == 0:
        return native.encode_with_spec(config, spec, pcm_list)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")

    B = len(pcm_list)
    Bb = _bucket(B)  # bounded shape variety, as the decoder's staging
    F, C = config.frame_length, config.num_channels
    layout = element_layout(C)
    el_specs = spec.element_specs(C)
    elem_specs = tuple(
        (ch.order, ch.den_shift, tuple(ch.pb_candidates) or (ch.pb_factor,), ch.mode,
         bool(ch.fit and not ch.coefs))
        for ch in el_specs
    )

    planes = np.zeros((Bb, C, F), np.int32)
    ns = np.zeros(Bb, np.int32)
    for i, p in enumerate(pcm_list):
        n = p.shape[0]
        ns[i] = n
        planes[i, :, :n] = np.asarray(p, np.int64).T.astype(np.int32)

    offsets = CHANNEL_LAYOUT_OFFSETS[C - 1]
    coefs_arr = np.zeros((len(layout), 32), np.int32)
    chan = 0
    for ei, (w, ch) in enumerate(zip(layout, el_specs)):
        first = np.asarray(pcm_list[0][:, offsets[chan]], np.int64)
        cvals = ch.initial_coefs(first if ch.order not in (0, 31) else None)
        coefs_arr[ei, : len(cvals)] = cvals
        chan += w

    walk_args = (
        torch.from_numpy(planes).to(device),
        torch.from_numpy(ns).to(device),
        torch.full((Bb,), spec.mix_res, dtype=I32, device=device),
        torch.from_numpy(coefs_arr).to(device),
    )
    walk_kw = dict(
        frame_length=F, num_channels=C, depth=config.bit_depth, pb=config.pb, mb=config.mb,
        kb=config.kb, elem_specs=elem_specs, mix_bits_s=max(spec.mix_bits, 0),
        bytes_shifted=spec.bytes_shifted, use_lfe_tag=spec.use_lfe_tag,
        force_escape=bool(spec.escape), auto_escape=bool(spec.auto_escape),
    )
    _note("encode_walk", walk_args, walk_kw)
    words, bits, ovf = encode_walk(*walk_args, **walk_kw)
    n_ovf = int(ovf.sum())
    if n_ovf:
        raise RuntimeError(f"encode kernel overflowed its row on {n_ovf} lanes")
    words = words.cpu().numpy()
    bits = bits.cpu().numpy()

    be = words.astype(">i4").tobytes()
    row_bytes = words.shape[1] * 4
    out = []
    for i in range(B):
        nbytes = (int(bits[i]) + 7) // 8
        out.append(be[i * row_bytes : i * row_bytes + nbytes])
    return out
