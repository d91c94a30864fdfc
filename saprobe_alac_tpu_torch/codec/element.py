"""Packet-level element dispatch (scalar oracle).

Behavioral parity with reference decoder.go:133-574: walks 3-bit element tags
(SCE/CPE/CCE/LFE/DSE/PCE/FIL/END), decodes single-channel and channel-pair
elements through the compressed (entropy + LPC) or escape (raw) paths, applies
the MPEG->SMPTE channel remap, and produces interleaved little-endian PCM.
"""

from __future__ import annotations

import numpy as np

from ..config import PacketConfig
from ..errors import (
    BitstreamOverrun,
    InvalidHeader,
    InvalidShift,
    SampleOverrun,
    UnsupportedElement,
)

from .bitcursor import BitCursor
from .golomb import AGParams, dyn_decomp
from .intops import s16, s32, sext
from .matrixing import apply_shift, format_samples, pack_pcm, unmix_stereo
from .predictor import NUM_ACTIVE_DELTA, UNUSED_HEADER_BITS, unpc_block

# Element type tags (decoder.go:67-76).
ELEM_SCE = 0
ELEM_CPE = 1
ELEM_CCE = 2
ELEM_LFE = 3
ELEM_DSE = 4
ELEM_PCE = 5
ELEM_FIL = 6
ELEM_END = 7

#: MPEG element order -> SMPTE interleave order, [num_channels-1][bitstream_idx]
#: (decoder.go:55-64; matches FFmpeg's ff_alac_channel_layout_offsets).
CHANNEL_LAYOUT_OFFSETS = (
    (0,),
    (0, 1),
    (2, 0, 1),
    (2, 0, 1, 3),
    (2, 0, 1, 3, 4),
    (2, 0, 1, 4, 5, 3),
    (2, 0, 1, 4, 5, 6, 3),
    (2, 6, 7, 0, 1, 4, 5, 3),
)

#: Bitstream channel index of the LFE channel (SMPTE output index 3), in
#: the layouts that have one.
LFE_BITSTREAM_IDX = {6: 5, 7: 6, 8: 7}

_ELEMENT_LAYOUT = {
    1: [1], 2: [2], 3: [1, 2], 4: [1, 2, 1], 5: [1, 2, 2],
    6: [1, 2, 2, 1], 7: [1, 2, 2, 1, 1], 8: [1, 2, 2, 2, 1],
}


def element_layout(num_channels: int) -> list[int]:
    """MPEG element sizes per channel count: 1 (SCE/LFE) and 2 (CPE), in
    bitstream order (what the encoders write)."""
    return _ELEMENT_LAYOUT[num_channels]


def _read_escape_value(bits: BitCursor, chan_bits: int) -> int:
    """One raw escape-path sample: chan_bits-wide sign-extended read.

    Equivalent to the reference's split 16+extra read for chan_bits > 16
    (decoder.go:326-345, 507-535).
    """
    return sext(bits.read(chan_bits), chan_bits)


def _decode_channel_compressed(
    config: PacketConfig,
    bits: BitCursor,
    chan_bits: int,
    num_samples: int,
    mode: int,
    den_shift: int,
    pb_factor: int,
    coefs: list[int],
) -> list[int]:
    """Entropy decode + prediction for one channel (decoder.go:296-311, 463-489)."""
    ag = AGParams.standard(
        mb=config.mb,
        pb=(config.pb * pb_factor) // 4,
        kb=config.kb,
        fw=num_samples,
        sw=num_samples,
        max_run=config.max_run,
    )
    residuals = dyn_decomp(ag, bits, num_samples, chan_bits)

    if mode != 0:
        # Two-stage: first a delta pass over the residuals (order 31, shift 0).
        residuals = unpc_block(residuals, num_samples, [], NUM_ACTIVE_DELTA, chan_bits, 0)

    return unpc_block(residuals, num_samples, coefs, len(coefs), chan_bits, den_shift)


def _read_predictor_header(bits: BitCursor) -> tuple[int, int, int, list[int]]:
    """mode/denShift, pbFactor/numCoefs, then int16 coefs (decoder.go:275-287)."""
    b = bits.read(8)
    mode = b >> 4
    den_shift = b & 0xF
    b = bits.read(8)
    pb_factor = b >> 5
    num = b & 0x1F
    coefs = [s16(bits.read(16)) for _ in range(num)]
    return mode, den_shift, pb_factor, coefs


def _element_header(bits: BitCursor, frame_length: int, num_samples: int) -> tuple[int, int, int]:
    """Common SCE/CPE header: returns (bytes_shifted, escape, num_samples).

    Guards partial-frame sample counts against the frame buffer size (the
    reference would panic on out-of-range counts; we raise SampleOverrun).
    """
    bits.read(4)  # element instance tag
    if bits.read(UNUSED_HEADER_BITS) != 0:
        raise InvalidHeader("nonzero unused header bits")
    header = bits.read(4)
    partial = header >> 3
    bytes_shifted = (header >> 1) & 0x3
    if bytes_shifted == 3:
        raise InvalidShift("bytesShifted == 3")
    escape = header & 0x1
    if partial:
        num_samples = (bits.read(16) << 16) | bits.read(16)
        if num_samples > frame_length:
            raise SampleOverrun(f"partial frame count {num_samples} > frame length {frame_length}")
    return bytes_shifted, escape, num_samples


def decode_packet(config: PacketConfig, packet: bytes) -> tuple[bytes, int]:
    """Decode one ALAC packet to (interleaved LE PCM bytes, num_samples).

    Scalar oracle equivalent of PacketDecoder.DecodePacket (decoder.go:117-128).
    """
    bits = BitCursor(packet)
    num_samples = config.frame_length
    num_chan = config.num_channels
    depth = config.bit_depth
    offsets = CHANNEL_LAYOUT_OFFSETS[num_chan - 1]

    # Output planes: (frame_length, num_chan) int64-valued int32 samples.
    planes = np.zeros((config.frame_length, num_chan), dtype=np.int64)
    chan_idx = 0

    while True:
        if bits.past_end():
            raise BitstreamOverrun("element loop ran past packet end")

        tag = bits.read(3)

        if tag in (ELEM_SCE, ELEM_LFE):
            out_chan = offsets[chan_idx]
            num_samples = _decode_sce(config, bits, planes, out_chan, num_samples)
            chan_idx += 1
        elif tag == ELEM_CPE:
            if chan_idx + 2 > num_chan:
                break
            out_chan = offsets[chan_idx]
            num_samples = _decode_cpe(config, bits, planes, out_chan, num_samples)
            chan_idx += 2
        elif tag in (ELEM_CCE, ELEM_PCE):
            raise UnsupportedElement(f"unsupported element tag {tag}")
        elif tag == ELEM_DSE:
            _skip_dse(bits)
        elif tag == ELEM_FIL:
            _skip_fil(bits)
        elif tag == ELEM_END:
            bits.byte_align()
            break

        if chan_idx >= num_chan:
            break

    pcm = pack_pcm(planes[:num_samples], depth)
    return pcm, num_samples


def _decode_sce(
    config: PacketConfig,
    bits: BitCursor,
    planes: np.ndarray,
    out_chan: int,
    num_samples: int,
) -> int:
    """Single Channel Element / LFE (decoder.go:210-265)."""
    depth = config.bit_depth
    bytes_shifted, escape, num_samples = _element_header(bits, config.frame_length, num_samples)
    chan_bits = depth - bytes_shifted * 8

    shift_vals = None
    if escape == 0:
        bits.read(8)  # mixBits (unused for mono)
        bits.read(8)  # mixRes (unused for mono)
        mode, den_shift, pb_factor, coefs = _read_predictor_header(bits)

        shift_cursor = None
        if bytes_shifted:
            shift_cursor = bits.copy()
            bits.advance(bytes_shifted * 8 * num_samples)

        mix_u = _decode_channel_compressed(
            config, bits, chan_bits, num_samples, mode, den_shift, pb_factor, coefs
        )

        if bytes_shifted:
            width = bytes_shifted * 8
            shift_vals = np.array(
                [shift_cursor.read(width) for _ in range(num_samples)], dtype=np.int64
            )
    else:
        # The reference reads sample-by-sample and crashes past the buffer;
        # we pre-check the whole raw region and raise instead.
        if bits.bitpos + chan_bits * num_samples > bits.size * 8:
            raise BitstreamOverrun("escape data region past packet end")
        mix_u = [_read_escape_value(bits, chan_bits) for _ in range(num_samples)]
        bytes_shifted = 0

    vals = np.asarray(mix_u, dtype=np.int64)
    if depth in (24, 32):
        # Only the 24/32-bit writers re-insert shift bits; the 16/20-bit
        # writers ignore bytesShifted entirely (matrix.go:220-250 vs 253-301).
        vals = apply_shift(vals, shift_vals, bytes_shifted)
    vals = format_samples(vals, depth)
    planes[:num_samples, out_chan] = vals
    return num_samples


def _decode_cpe(
    config: PacketConfig,
    bits: BitCursor,
    planes: np.ndarray,
    out_chan: int,
    num_samples: int,
) -> int:
    """Channel Pair Element (decoder.go:348-535)."""
    depth = config.bit_depth
    bytes_shifted, escape, num_samples = _element_header(bits, config.frame_length, num_samples)
    # CPE has +1 bit for decorrelation (decoder.go:371).
    chan_bits = depth - bytes_shifted * 8 + 1

    mix_bits = 0
    mix_res = 0
    shift_u = shift_v = None

    if escape == 0:
        mix_bits = bits.read(8)
        mix_res = s32(sext(bits.read(8), 8))  # int8 sign-extend (decoder.go:422)

        mode_u, den_u, pbf_u, coefs_u = _read_predictor_header(bits)
        mode_v, den_v, pbf_v, coefs_v = _read_predictor_header(bits)

        shift_cursor = None
        if bytes_shifted:
            shift_cursor = bits.copy()
            bits.advance(bytes_shifted * 8 * 2 * num_samples)

        mix_u = _decode_channel_compressed(
            config, bits, chan_bits, num_samples, mode_u, den_u, pbf_u, coefs_u
        )
        mix_v = _decode_channel_compressed(
            config, bits, chan_bits, num_samples, mode_v, den_v, pbf_v, coefs_v
        )

        if bytes_shifted:
            width = bytes_shifted * 8
            pairs = np.array(
                [shift_cursor.read(width) for _ in range(2 * num_samples)], dtype=np.int64
            )
            shift_u = pairs[0::2]
            shift_v = pairs[1::2]
    else:
        chan_bits = depth  # reset for escape (decoder.go:388)
        if bits.bitpos + chan_bits * 2 * num_samples > bits.size * 8:
            raise BitstreamOverrun("escape data region past packet end")
        mix_u = []
        mix_v = []
        for _ in range(num_samples):
            mix_u.append(_read_escape_value(bits, chan_bits))
            mix_v.append(_read_escape_value(bits, chan_bits))
        bytes_shifted = 0

    u = np.asarray(mix_u, dtype=np.int64)
    v = np.asarray(mix_v, dtype=np.int64)
    left, right = unmix_stereo(u, v, mix_bits, mix_res)
    if depth in (24, 32):
        # 16/20-bit writers ignore the shift buffer (matrix.go:30-105).
        left = apply_shift(left, shift_u, bytes_shifted)
        right = apply_shift(right, shift_v, bytes_shifted)
    left = format_samples(left, depth)
    right = format_samples(right, depth)
    planes[:num_samples, out_chan] = left
    planes[:num_samples, out_chan + 1] = right
    return num_samples


def _skip_fil(bits: BitCursor) -> None:
    """Fill Element (decoder.go:538-551)."""
    count = bits.read(4)
    if count == 15:
        count += bits.read(8) - 1
    bits.advance(count * 8)
    if bits.past_end():
        raise BitstreamOverrun("FIL element ran past packet end")


def _skip_dse(bits: BitCursor) -> None:
    """Data Stream Element (decoder.go:554-574)."""
    bits.read(4)  # element instance tag
    align = bits.read(1)
    count = bits.read(8)
    if count == 255:
        count += bits.read(8)
    if align:
        bits.byte_align()
    bits.advance(count * 8)
    if bits.past_end():
        raise BitstreamOverrun("DSE element ran past packet end")
