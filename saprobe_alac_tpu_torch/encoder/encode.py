"""Packet encoding on four backends: the card, its plain versions on the
CPU, the C++ host core and the pure-Python encoder.

Counterpart of saprobe_alac_tpu/encoder/encode.py.  `encode_packets` takes
the decoder's backend words, mapped here and nowhere else: ``"cuda"`` (the
default; any CUDA device) and ``"cpu"`` run the lane-parallel encoder of
ops/encode_device.py there (the kernels, or their plain versions),
``"native"`` the repo's C++ core (``native.encode_with_spec``) and
``"python"`` `encode_packet` below.

The Python encoder is the exact inverse of the decode math in codec/golomb.py
and codec/predictor.py.  Encoder and decoder adaptive state (Golomb mean,
LPC coefficients) stay in lockstep because both adapt from the transmitted
residuals.  Residual representability: the decoder reconstructs
``out = sext(del + top + sum1, chan_bits)``, so the encoder is free to pick
any ``del`` congruent to ``out - top - sum1`` mod 2^chan_bits.  It picks the
minimal representative ``sext(out - top - sum1, chan_bits)``, which
guarantees the unsigned-mapped value fits the Golomb escape width (maxSize =
chan_bits).
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec.element import CHANNEL_LAYOUT_OFFSETS, LFE_BITSTREAM_IDX, element_layout
from ..codec.golomb import (
    BITOFF,
    MAX_DATATYPE_16,
    MAX_PREFIX_16,
    MAX_PREFIX_32,
    MAX_ZERO_RUN,
    MDEN_SHIFT,
    MMUL_SHIFT,
    MOFF,
    N_MAX_MEAN_CLAMP,
    N_MEAN_CLAMP_VAL,
    QB_SHIFT,
    QUANT_BITS,
    AGParams,
)
from ..codec.intops import lead, lg3a, s16, s32, sext, sshr32, u32
from ..codec.predictor import _INT32_COEF_ORDERS, NUM_ACTIVE_DELTA, UNUSED_HEADER_BITS, sign_of_int
from ..config import PacketConfig
from .bitwriter import BitWriter
from .spec import ChannelSpec, EncoderSpec

#: The encoder's backend words (the decoder's, and ``"python"``).
BACKENDS = ("cuda", "cpu", "native", "python")


# --- Golomb-Rice encoding (inverse of codec/golomb.py) ---


def _rice_code(writer: BitWriter, value: int, m: int, k: int, max_size: int, max_prefix: int) -> None:
    """Emit one Golomb codeword for ``value`` given divisor state (m, k)."""
    q, r = divmod(value, m) if m > 0 else (max_prefix, 0)
    if q >= max_prefix:
        writer.write_ones(max_prefix)
        writer.write(value, max_size)
        return
    writer.write_ones(q)
    writer.write(0, 1)
    if k == 1:
        return  # decoder skips the k-bit field entirely
    if r == 0:
        writer.write(0, k - 1)  # decoder reads k bits, sees v<2, consumes k-1
    else:
        writer.write(r + 1, k)


def ag_encode(params: AGParams, residuals: list[int], max_size: int) -> BitWriter | None:
    """Entropy-encode signed residuals; exact inverse of dyn_decomp.

    Returns None if a residual cannot be represented (caller should fall back
    to the escape element path); with minimal-representative residuals this
    does not happen.
    """
    writer = BitWriter()
    mean = params.mb0
    zmode = 0
    pb = params.pb
    kb = params.kb
    wb = params.wb
    num = len(residuals)
    i = 0

    while i < num:
        del_ = residuals[i]
        # Unsigned mapping: n = 2*del for del>0, -2*del-1 for del<0, 0 for 0.
        n = 2 * del_ if del_ >= 0 else -2 * del_ - 1
        value = n - zmode
        if value < 0 or (max_size < 33 and value >= (1 << max_size)):
            return None

        m = mean >> QB_SHIFT
        k = min(lg3a(m), kb)
        m = (1 << k) - 1
        _rice_code(writer, value, m, k, max_size, MAX_PREFIX_32)
        i += 1

        mean = u32(pb * n + mean - ((pb * mean & 0xFFFFFFFF) >> QB_SHIFT))
        if value > N_MAX_MEAN_CLAMP:
            mean = N_MEAN_CLAMP_VAL
        zmode = 0

        # Zero-run mode mirror (codec/golomb.py): encode the actual zero run.
        if u32(mean << MMUL_SHIFT) < QUANT_BITS and i < num:
            zmode = 1
            k32 = max(lead(mean) - BITOFF + ((mean + MOFF) >> MDEN_SHIFT), 0)
            mz = ((1 << k32) - 1) & wb

            run = 0
            while i + run < num and residuals[i + run] == 0 and run < MAX_ZERO_RUN:
                run += 1
            _rice_code(writer, run, mz, k32, MAX_DATATYPE_16, MAX_PREFIX_16)
            i += run
            if run >= MAX_ZERO_RUN:
                zmode = 0
            mean = 0

    return writer


# --- LPC forward pass (inverse of codec/predictor.py) ---


def lpc_forward(
    samples: list[int],
    coefs: list[int],
    num_active: int,
    chan_bits: int,
    den_shift: int,
) -> list[int]:
    """Compute prediction residuals such that unpc_block(residuals) == samples.

    Adapts coefficients identically to the decoder (driven by the transmitted
    residual signs), so both sides stay in lockstep.
    """
    num = len(samples)
    if num == 0:
        return []
    res = [0] * num
    res[0] = samples[0]

    if num_active == 0:
        res[1:] = samples[1:]
        return res

    if num_active == NUM_ACTIVE_DELTA:
        for i in range(1, num):
            res[i] = sext(samples[i] - samples[i - 1], chan_bits)
        return res

    for i in range(1, min(num_active + 1, num)):
        res[i] = sext(samples[i] - samples[i - 1], chan_bits)

    lim = num_active + 1
    den_half = (1 << (den_shift - 1)) if den_shift > 0 else 0
    wrap16 = num_active not in _INT32_COEF_ORDERS
    c = [s32(x) for x in coefs[:num_active]]

    for idx in range(lim, num):
        top = samples[idx - lim]
        acc = 0
        for k in range(num_active):
            acc += c[k] * (samples[idx - 1 - k] - top)
        sum1 = sshr32(s32(acc + den_half), den_shift)

        # Minimal-representative residual (see module docstring).
        del_ = sext(samples[idx] - top - sum1, chan_bits)
        res[idx] = del_

        sign = sign_of_int(del_)
        del0 = del_
        if sign != 0:
            for j in range(1, num_active + 1):
                k = num_active - j
                dd = s32(top - samples[idx - 1 - k])
                sgn = sign_of_int(dd) * sign
                nc = c[k] - sgn
                c[k] = s16(nc) if wrap16 else s32(nc)
                del0 = s32(del0 - j * sshr32(s32(sgn * dd), den_shift))
                if sign > 0 and del0 <= 0:
                    break
                if sign < 0 and del0 >= 0:
                    break

    return res


# --- Channel mixing (inverse of codec/matrixing.py unmix) ---


def mix_stereo(left: np.ndarray, right: np.ndarray, mix_bits: int, mix_res: int) -> tuple[np.ndarray, np.ndarray]:
    """Decorrelate a channel pair.  Inverse of unmix for any (mix_bits, mix_res):

    v = left - right;  u = right + ((mix_res * v) >> mix_bits)
    """
    left = left.astype(np.int64)
    right = right.astype(np.int64)
    if mix_res == 0:
        return left, right
    v = left - right
    u = right + ((mix_res * v) >> mix_bits)
    return u, v


# --- Element and packet assembly ---


def _write_element_header(
    writer: BitWriter,
    tag: int,
    partial: bool,
    bytes_shifted: int,
    escape: int,
    num_samples: int,
) -> None:
    writer.write(tag, 3)
    writer.write(0, 4)  # element instance tag
    writer.write(0, UNUSED_HEADER_BITS)
    writer.write((int(partial) << 3) | (bytes_shifted << 1) | escape, 4)
    if partial:
        writer.write(num_samples >> 16, 16)
        writer.write(num_samples & 0xFFFF, 16)


def _encode_channel_body(
    config: PacketConfig,
    spec: ChannelSpec,
    samples: list[int],
    chan_bits: int,
) -> tuple[BitWriter, BitWriter]:
    """Predictor header bits + entropy bits for one channel.

    With ``spec.pb_candidates`` set, the body is entropy-encoded once per
    pbFactor candidate and the smallest wins (adaptive pbFactor — the field
    is per channel header, so each channel adapts independently).
    """
    order = spec.order
    if not 0 <= order <= 31:
        raise ValueError(f"order {order} not representable in the 5-bit numCoefs field")
    coefs = spec.initial_coefs(np.asarray(samples) if order not in (0, 31) else None)

    res = lpc_forward(samples, coefs, order, chan_bits, spec.den_shift)
    if spec.mode != 0:
        # Decoder un-deltas first, so the stream carries delta'd residuals.
        stream_res = [res[0]] + [sext(res[i] - res[i - 1], chan_bits) for i in range(1, len(res))]
    else:
        stream_res = res

    # At chan_bits == 32 a residual of INT32_MIN is uncodable: its unsigned
    # mapping is 2^32-1 and the decoder's ((nd+1)>>1) wraps it to 0 (the
    # reference decoder does the same).  Fall back to the verbatim element.
    if chan_bits >= 32 and any(r == -(1 << 31) for r in stream_res):
        return None

    best = None
    for pbf in spec.pb_candidates or (spec.pb_factor,):
        if not 0 <= pbf <= 7:
            raise ValueError(f"pb_factor {pbf} not representable in the 3-bit field")
        ag = AGParams.standard(
            mb=config.mb,
            pb=(config.pb * pbf) // 4,
            kb=config.kb,
            fw=len(samples),
            sw=len(samples),
            max_run=config.max_run,
        )
        body = ag_encode(ag, stream_res, chan_bits)
        if body is None:
            # A residual doesn't fit the escape width; callers fall back to
            # the verbatim element.  Unreachable given minimal-representative
            # residuals + the mix-overflow guard, but kept as belt-and-braces.
            return None
        if best is None or body.bit_length < best[1].bit_length:
            best = (pbf, body)

    pbf, body = best
    header = BitWriter()
    header.write((spec.mode << 4) | spec.den_shift, 8)
    header.write((pbf << 5) | order, 8)
    for c in coefs:
        header.write(c & 0xFFFF, 16)
    return header, body


def _split_shift(vals: np.ndarray, bytes_shifted: int) -> tuple[list[int], np.ndarray]:
    """Split samples into (high parts, low shift bits)."""
    if bytes_shifted == 0:
        return [int(x) for x in vals], np.zeros(0, dtype=np.int64)
    shift = bytes_shifted * 8
    high = [int(x) >> shift for x in vals.astype(np.int64)]
    low = vals.astype(np.int64) & ((1 << shift) - 1)
    return high, low


def encode_packet(
    config: PacketConfig,
    spec: EncoderSpec,
    pcm: np.ndarray,
) -> bytes:
    """Encode one packet.  ``pcm`` is (num_samples, num_channels) int32-valued
    samples in SMPTE order (20-bit depth: values are the raw 20-bit range).
    """
    num_samples, num_chan = pcm.shape
    assert num_chan == config.num_channels
    depth = config.bit_depth
    partial = num_samples != config.frame_length
    offsets = CHANNEL_LAYOUT_OFFSETS[num_chan - 1]

    writer = BitWriter()
    layout = element_layout(num_chan)
    lfe_idx = LFE_BITSTREAM_IDX.get(num_chan, -1)

    if spec.elements is not None and len(spec.elements) != len(layout):
        raise ValueError(
            f"spec.elements has {len(spec.elements)} entries; "
            f"{num_chan}-channel layout has {len(layout)} elements"
        )

    chan_idx = 0
    for ei, width in enumerate(layout):
        chspec = spec.elements[ei] if spec.elements is not None else spec.channel
        if width == 1:
            tag = 3 if (spec.use_lfe_tag and chan_idx == lfe_idx) else 0  # LFE : SCE
            samples = pcm[:, offsets[chan_idx]]
            elem = _encode_sce(config, spec, chspec, tag, samples, partial, num_samples)
            chan_idx += 1
        else:
            left = pcm[:, offsets[chan_idx]]
            right = pcm[:, offsets[chan_idx] + 1]
            elem = _encode_cpe(config, spec, chspec, left, right, partial, num_samples)
            chan_idx += 2
        _append(writer, elem)

    writer.write(7, 3)  # END
    writer.byte_align()
    return writer.getvalue()


def _pick(compressed: BitWriter, escaped: BitWriter, spec: EncoderSpec) -> BitWriter:
    """Escape the element when forced, or when raw is smaller (auto_escape).

    Mirrors real encoders' verbatim fallback: incompressible (noise-like)
    blocks come out as raw chan_bits-wide samples.
    """
    if spec.escape:
        return escaped
    if spec.auto_escape and escaped.bit_length < compressed.bit_length:
        return escaped
    return compressed


def _encode_sce(
    config: PacketConfig,
    spec: EncoderSpec,
    chspec: ChannelSpec,
    tag: int,
    samples: np.ndarray,
    partial: bool,
    num_samples: int,
) -> BitWriter:
    depth = config.bit_depth
    samples = samples.astype(np.int64)

    escaped = BitWriter()
    _write_element_header(escaped, tag, partial, 0, 1, num_samples)
    for x in samples:
        escaped.write(int(x) & ((1 << depth) - 1), depth)
    if spec.escape:
        return escaped

    writer = BitWriter()
    # Shift-buffer bits are only re-inserted by the 24/32-bit writers
    # (matrix.go); shifting at 16/20-bit would lose the low bits.
    bytes_shifted = spec.bytes_shifted if depth >= 24 else 0
    chan_bits = depth - bytes_shifted * 8
    _write_element_header(writer, tag, partial, bytes_shifted, 0, num_samples)
    writer.write(0, 8)  # mixBits (unused for mono)
    writer.write(0, 8)  # mixRes (unused for mono)

    high, low = _split_shift(samples, bytes_shifted)
    hb = _encode_channel_body(config, chspec, high, chan_bits)
    if hb is None:
        return escaped
    header, body = hb

    _append(writer, header)
    if bytes_shifted:
        width = bytes_shifted * 8
        for x in low:
            writer.write(int(x), width)
    _append(writer, body)
    return _pick(writer, escaped, spec)


def _encode_cpe(
    config: PacketConfig,
    spec: EncoderSpec,
    chspec: ChannelSpec,
    left: np.ndarray,
    right: np.ndarray,
    partial: bool,
    num_samples: int,
) -> BitWriter:
    depth = config.bit_depth

    escaped = BitWriter()
    _write_element_header(escaped, 1, partial, 0, 1, num_samples)
    mask = (1 << depth) - 1
    for l, r in zip(left.astype(np.int64), right.astype(np.int64)):
        escaped.write(int(l) & mask, depth)
        escaped.write(int(r) & mask, depth)
    if spec.escape:
        return escaped

    writer = BitWriter()
    bytes_shifted = spec.bytes_shifted if depth >= 24 else 0
    if depth == 32:
        # chanBits = 32 - 0 + 1 = 33 hits degenerate Go shift saturation in the
        # decoder (predictor sext zeroes everything); always shift >= 1 byte.
        bytes_shifted = max(bytes_shifted, 1)
    chan_bits = depth - bytes_shifted * 8 + 1
    _write_element_header(writer, 1, partial, bytes_shifted, 0, num_samples)

    lh, ll = _split_shift(left.astype(np.int64), bytes_shifted)
    rh, rl = _split_shift(right.astype(np.int64), bytes_shifted)
    mix_res = spec.mix_res
    u, v = mix_stereo(np.asarray(lh, dtype=np.int64), np.asarray(rh, dtype=np.int64), spec.mix_bits, mix_res)

    # Decorrelated values must fit chan_bits (the decoder sign-extends to
    # chan_bits, so out-of-range u would decode lossily); fall back to
    # independent channels when an aggressive mix_res overflows.
    lim = 1 << (chan_bits - 1)
    if mix_res != 0 and u.size and (max(u.max(), v.max(), 0) >= lim or min(u.min(), v.min(), 0) < -lim):
        mix_res = 0
        u, v = np.asarray(lh, dtype=np.int64), np.asarray(rh, dtype=np.int64)

    mix_bits = spec.mix_bits if mix_res != 0 else 0
    writer.write(mix_bits, 8)
    writer.write(mix_res & 0xFF, 8)

    hb_u = _encode_channel_body(config, chspec, [int(x) for x in u], chan_bits)
    hb_v = _encode_channel_body(config, chspec, [int(x) for x in v], chan_bits)
    if hb_u is None or hb_v is None:
        return escaped
    header_u, body_u = hb_u
    header_v, body_v = hb_v

    _append(writer, header_u)
    _append(writer, header_v)

    if bytes_shifted:
        width = bytes_shifted * 8
        for a, b in zip(ll, rl):
            writer.write(int(a), width)
            writer.write(int(b), width)

    _append(writer, body_u)
    _append(writer, body_v)
    return _pick(writer, escaped, spec)


def _append(dst: BitWriter, src: BitWriter) -> None:
    """Append all bits of src to dst."""
    data = src.getvalue()
    nbits = src.bit_length
    full, rem = divmod(nbits, 8)
    for byte in data[:full]:
        dst.write(byte, 8)
    if rem:
        dst.write(data[full] >> (8 - rem), rem)


def encode_packets(config: PacketConfig, spec: EncoderSpec, pcm: np.ndarray,
                   backend="cuda") -> list[bytes]:
    """Encode (total_samples, channels) PCM into packets of ``frame_length``
    samples, the last one partial.

    ``backend``: ``"cuda"`` (default; raises without a card), ``"cpu"`` or
    any torch device for the device encoder, ``"native"`` for the C++ host
    core, ``"python"`` for `encode_packet`.  All write the same format and,
    given the same initial coefficients, the same bytes.  With fitting on,
    the device fits each packet's channels in float32, the host core in
    float64 (Levinson-Durbin) and the Python encoder in float64 (least
    squares), so their packets may differ in size; all decode to the
    source."""
    frame = config.frame_length
    chunks = [pcm[start : start + frame] for start in range(0, pcm.shape[0], frame)]
    if backend == "python":
        return [encode_packet(config, spec, chunk) for chunk in chunks]
    if backend == "native":
        from .. import native

        return native.encode_with_spec(config, spec, chunks)
    try:
        device = torch.device(backend)
    except (RuntimeError, TypeError):
        raise ValueError(f"unknown encoder backend {backend!r}; want one of {BACKENDS}") from None
    from ..ops.encode_device import encode_packets_device

    return encode_packets_device(config, spec, chunks, device=device)
