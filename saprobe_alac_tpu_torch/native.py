"""ctypes binding to the repo's C++ host core (native/alac_core.cpp,
alac_encode.cpp, alac_trim.cpp and alac_stage.cpp), built by g++ into
``_build/`` at first use.

The port's host side: the threaded packers that stage a batch as big-endian
words (`pack_rows`, into a caller's reused buffer straight from the packets;
`pack_packets`, into a fresh array from a joined copy, its reference), the
exact host decode (one packet, or a batch: the packets the device
flags and the ``"native"`` backend), the packet encoder (fixtures, and
the host backend of `encoder.encode_packets`), and the threaded trim of a
large decoded batch's rows to ``bytes`` (`rows_to_bytes`).  ``-fwrapv`` is
required: the codec relies on wrapping int32 arithmetic as Go does.  A
failed build raises.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

from ._build import build_library
from .encoder.spec import ChannelSpec, EncoderSpec
from .errors import UnsupportedSpec, core_error

_NATIVE = Path(__file__).resolve().parents[1] / "native"
_SOURCES = [_NATIVE / "alac_core.cpp", _NATIVE / "alac_encode.cpp", _NATIVE / "alac_trim.cpp",
            _NATIVE / "alac_stage.cpp"]

#: Extra zero words past the longest packet, so reads past a packet's end
#: see zeros (bitbuffer.go:28-32).
GUARD_WORDS = 2

BYTES_PER_SAMPLE = {16: 2, 20: 3, 24: 3, 32: 4}

_lock = threading.Lock()
_lib = None


class _Config(ctypes.Structure):
    _fields_ = [
        (name, ctypes.c_uint32)
        for name in ("frame_length", "bit_depth", "num_channels", "pb", "mb", "kb", "max_run")
    ]


class _EncSpec(ctypes.Structure):
    _fields_ = [
        (name, ctypes.c_int32)
        for name in (
            "order", "den_shift", "pb_factor", "mode", "mix_bits", "mix_res",
            "bytes_shifted", "force_escape", "auto_escape", "use_lfe_tag", "fit",
        )
    ] + [("coefs", ctypes.c_int16 * 32)]


def _argv(out):
    return ["g++", "-O3", "-shared", "-fPIC", "-fwrapv", "-fopenmp", "-o", str(out)] + [
        str(s) for s in _SOURCES
    ]


def load():
    """The loaded host core; builds it first when the sources changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library("libalac_host", _SOURCES, _argv)))
        P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.alac_pack_packets.restype = I32
        lib.alac_pack_packets.argtypes = [P, P, P, I32, I32, P]
        lib.alac_pack_rows.restype = None
        lib.alac_pack_rows.argtypes = [P, P, I32, I32, I32, P]
        lib.alac_decode_packet.restype = I32
        lib.alac_decode_packet.argtypes = [P, P, I32, P, I64, P]
        lib.alac_decode_batch.restype = I32
        lib.alac_decode_batch.argtypes = [P, P, P, P, I32, P, I64, P, P, I32]
        lib.alac_encode_packet.restype = I32
        lib.alac_encode_packet.argtypes = [P, P, P, I32, P, I64]
        lib.alac_copy_rows.restype = I32
        lib.alac_copy_rows.argtypes = [P, I64, P, P, I32]
        _lib = lib
        return _lib


def _config(config) -> _Config:
    return _Config(**{name: getattr(config, name) for name, _ in _Config._fields_})


def _flat(packets: Sequence[bytes]):
    """Concatenated bytes (never empty), int64 offsets and int32 sizes."""
    sizes = np.fromiter((len(p) for p in packets), dtype=np.int32, count=len(packets))
    offsets = np.zeros(len(packets), dtype=np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    flat = np.frombuffer(b"".join(packets) or b"\0", dtype=np.uint8)
    return flat, offsets, sizes


def pack_packets(packets: Sequence[bytes], rows: int, width: int) -> np.ndarray:
    """(rows, width) int32 words in big-endian bit order (bit 31 of word 0
    is a packet's first bit), zero past each packet and in rows past the
    last packet.  ``width`` must cover the longest packet plus GUARD_WORDS."""
    flat, offsets, sizes = _flat(packets)
    if len(packets) > rows or (int(sizes.max(initial=0)) + 3) // 4 + GUARD_WORDS > width:
        raise ValueError(f"{len(packets)} packets do not fit a ({rows}, {width}) batch")
    out = np.zeros((rows, width), dtype=np.uint32)
    load().alac_pack_packets(
        flat.ctypes.data, offsets.ctypes.data, sizes.ctypes.data, len(packets), width,
        out.ctypes.data,
    )
    return out.view(np.int32)


# CPython's own constructor of a `bytes` left uninitialised, and its data
# pointer, on prototypes of this module's own (the shared
# `ctypes.pythonapi` attributes are left as they are); then the offset of a
# `bytes` object's data from its address (`id`), the same for every one.
_new_bytes = ctypes.PYFUNCTYPE(ctypes.py_object, ctypes.c_char_p, ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))
_bytes_data = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.py_object)(
    ("PyBytes_AsString", ctypes.pythonapi))
_probe = _new_bytes(None, 1)
if type(_probe) is not bytes:
    raise TypeError(f"PyBytes_FromStringAndSize gave {type(_probe).__name__}")
_DATA_OFFSET = _bytes_data(_probe) - id(_probe)
del _probe


def packet_lengths(packets: Sequence) -> np.ndarray:
    """Each packet's length in bytes, int32: the one read of the sizes that
    a batch's staging takes its widths, size_bits and `pack_rows` from."""
    return np.fromiter(map(len, packets), dtype=np.int32, count=len(packets))


def pack_rows(packets: Sequence, lengths: np.ndarray, out: np.ndarray) -> None:
    """Write ``packets`` into ``out`` as `pack_packets` returns them:
    (rows, width) words in big-endian bit order, zero past each packet and
    in the rows past the last packet.  Every word of ``out`` is written, so
    a reused buffer shows nothing of an earlier batch.  ``lengths`` must be
    the packets' `packet_lengths` (the core reads that many bytes of each);
    ``out``: a C-contiguous 2-D array of 4-byte words whose width covers the
    longest packet plus GUARD_WORDS.

    `bytes` packets are read in place on OpenMP's threads (their data
    pointers, as `rows_to_bytes` finds them); a batch holding any other
    buffer (memoryview, bytearray) is joined into one copy first."""
    rows, width = out.shape
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    if out.itemsize != 4 or not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError("out must be a writeable C-contiguous array of 4-byte words")
    if len(lengths) != len(packets) or len(packets) > rows or (
            int(lengths.max(initial=0)) + 3) // 4 + GUARD_WORDS > width:
        raise ValueError(f"{len(packets)} packets do not fit a ({rows}, {width}) batch")
    if all(type(p) is bytes for p in packets):
        # The caller's list holds the objects for the whole call.
        ptrs = np.fromiter(map(id, packets), dtype=np.uintp, count=len(packets))
        ptrs += _DATA_OFFSET
    else:
        flat, offsets, _ = _flat(packets)
        ptrs = (offsets + flat.ctypes.data).astype(np.uintp)
    load().alac_pack_rows(ptrs.ctypes.data, lengths.ctypes.data, len(packets), rows, width,
                          out.ctypes.data)


def rows_to_bytes(rows: np.ndarray, lengths: np.ndarray,
                  spare: list | None = None) -> tuple[list[bytes], int]:
    """Each row's first ``lengths[i]`` bytes as a `bytes` of its own (for a
    length 0, ``b""``), and the number of threads that copied.  The objects
    are made uninitialised under the GIL, then one call into the core fills
    them all on OpenMP's threads with the GIL released.  ``rows``: a 2-D
    array (copied first where not C-contiguous); ``lengths``: at most a
    row's bytes.

    ``spare``: earlier outputs the caller gives up (the list is emptied).
    One is dropped just before each object is made, so where nothing else
    holds them, the memory they leave makes the new objects: pages already
    faulted in, where a batch dropped all at once would have gone back to
    the kernel (glibc returns the top of its heap) and faulted in anew."""
    rows = np.ascontiguousarray(rows)
    row_bytes = rows.shape[1] * rows.itemsize
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    if len(lengths) != len(rows) or (
            len(rows) and not 0 <= lengths.min() <= lengths.max() <= row_bytes):
        raise ValueError(f"lengths do not fit {len(rows)} rows of {row_bytes} bytes")
    spare = spare if spare is not None else []
    out = []
    for k in lengths.tolist():
        if spare:
            spare.pop()
        out.append(_new_bytes(None, k) if k else b"")
    spare.clear()
    # Nothing else holds these objects yet, and the core writes only their
    # data, never a header, so it may run without the GIL; a length 0 (the
    # shared b"") is skipped by the core, so nothing is written to it.
    dst = np.array([id(b) + _DATA_OFFSET for b in out], dtype=np.uintp)
    threads = load().alac_copy_rows(rows.ctypes.data, row_bytes, lengths.ctypes.data,
                                    dst.ctypes.data, len(out))
    return out, threads


def decode_packet(config, packet: bytes) -> bytes:
    """One packet's interleaved LE PCM by the core (the counterpart of
    saprobe_alac_tpu.native.decode_packet); a packet the core rejects
    raises the class of its error code."""
    cap = config.frame_length * config.num_channels * BYTES_PER_SAMPLE[config.bit_depth]
    out = np.empty(cap, dtype=np.uint8)
    out_len = ctypes.c_int32(0)
    code = load().alac_decode_packet(
        ctypes.byref(_config(config)), packet, len(packet), out.ctypes.data, cap,
        ctypes.byref(out_len),
    )
    if code != 0:
        raise core_error(code)
    return out[: out_len.value].tobytes()


def decode_batch(config, packets: Sequence[bytes]):
    """Threaded host decode: (out uint8 (B, stride), lens, errs); a nonzero
    err marks a packet the core rejected."""
    flat, offsets, sizes = _flat(packets)
    stride = config.frame_length * config.num_channels * BYTES_PER_SAMPLE[config.bit_depth]
    out = np.zeros((len(packets), stride), dtype=np.uint8)
    lens = np.zeros(len(packets), dtype=np.int32)
    errs = np.zeros(len(packets), dtype=np.int32)
    load().alac_decode_batch(
        ctypes.byref(_config(config)), flat.ctypes.data, offsets.ctypes.data,
        sizes.ctypes.data, len(packets), out.ctypes.data, stride, lens.ctypes.data,
        errs.ctypes.data, 0,
    )
    return out, lens, errs


def _encode_blocks(config, c_spec: _EncSpec, blocks) -> list[bytes]:
    """One packet per (ns, channels) block through the core's encoder."""
    cfg = _config(config)
    lib = load()
    out = []
    for block in blocks:
        block = np.ascontiguousarray(block, dtype=np.int32)
        if block.ndim != 2 or block.shape[1] != config.num_channels:
            raise ValueError(f"pcm must be (n, {config.num_channels}), got {block.shape}")
        ns, channels = block.shape
        cap = ns * channels * 8 + 4096 * channels
        buf = np.empty(cap, dtype=np.uint8)
        n = lib.alac_encode_packet(
            ctypes.byref(cfg), ctypes.byref(c_spec), block.ctypes.data, ns, buf.ctypes.data, cap
        )
        if n < 0:
            raise ValueError(f"native encode failed with code {n}")
        out.append(buf[:n].tobytes())
    return out


def encode_packets(config, pcm: np.ndarray, *, order: int = 4, mode: int = 0,
                   escape: bool = False, bytes_shifted: int = 0) -> list[bytes]:
    """Encode (n, channels) integer PCM into packets of ``frame_length``
    samples (the last one partial) under the default `EncoderSpec` but for
    the keywords (so den_shift 9, pb_factor 4, mix_bits 1, mix_res 1).  The
    core fits each channel's initial LPC coefficients per packet; near-white
    blocks become escape elements when that is smaller, and ``escape``
    forces them.  ``bytes_shifted`` (0..2) moves the low bytes of 24/32-bit
    samples into the shift region; the core ignores it below 24 bits and
    raises it to 1 for a 32-bit pair (native/alac_encode.cpp:292-293)."""
    if pcm.ndim != 2:
        raise ValueError(f"pcm must be (n, {config.num_channels}), got {pcm.shape}")
    spec = EncoderSpec(channel=ChannelSpec(order=order, mode=mode), escape=escape,
                       bytes_shifted=bytes_shifted)
    F = config.frame_length
    return encode_with_spec(config, spec, (pcm[s : s + F] for s in range(0, pcm.shape[0], F)))


def encode_with_spec(config, spec: EncoderSpec, blocks) -> list[bytes]:
    """One packet per (ns, channels) block, encoded by the core under an
    `EncoderSpec` (the counterpart of saprobe_alac_tpu.native.encode_packet).
    With ``fit`` on and no pinned coefficients the core fits each channel
    per packet (float64 Levinson-Durbin) and falls back to the default
    coefficients on a degenerate block.  The core takes one channel spec
    for all elements, one pbFactor and int16 coefficients: a spec beyond
    that raises `UnsupportedSpec` rather than encoding something else."""
    ch = spec.channel
    if spec.elements is not None:
        ch = spec.element_specs(config.num_channels)[0]
        if any(e != ch for e in spec.elements):
            raise UnsupportedSpec("the host core takes one ChannelSpec for every element")
    if len(ch.pb_candidates) > 1:
        raise UnsupportedSpec("the host core takes one pbFactor, not pb_candidates")
    pb_factor = ch.pb_candidates[0] if ch.pb_candidates else ch.pb_factor
    coefs = ch.initial_coefs(None)
    if not 0 <= ch.order <= 31 or not 0 <= pb_factor <= 7:
        raise UnsupportedSpec(f"order {ch.order} or pbFactor {pb_factor} out of range")
    if any(not -(1 << 15) <= c < (1 << 15) for c in coefs):
        raise UnsupportedSpec("the host core takes int16 initial coefficients")
    c_spec = _EncSpec(
        order=ch.order, den_shift=ch.den_shift, pb_factor=pb_factor, mode=ch.mode,
        mix_bits=max(spec.mix_bits, 0), mix_res=spec.mix_res,
        bytes_shifted=spec.bytes_shifted, force_escape=int(spec.escape),
        auto_escape=int(spec.auto_escape), use_lfe_tag=int(spec.use_lfe_tag),
        fit=int(ch.fit and not ch.coefs), coefs=(ctypes.c_int16 * 32)(*coefs),
    )
    return _encode_blocks(config, c_spec, blocks)
