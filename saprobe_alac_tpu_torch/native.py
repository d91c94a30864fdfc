"""ctypes binding to the repo's C++ host core (native/alac_core.cpp and
native/alac_encode.cpp), built by g++ into ``_build/`` at first use.

The port's host side: the threaded packer that stages a batch as big-endian
words, the exact host decode for packets the device flags, and the packet
encoder used to make fixtures.  ``-fwrapv`` is required: the codec relies
on wrapping int32 arithmetic as Go does.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

from ._build import build_library

_NATIVE = Path(__file__).resolve().parents[1] / "native"
_SOURCES = [_NATIVE / "alac_core.cpp", _NATIVE / "alac_encode.cpp"]

#: Extra zero words past the longest packet, so reads past a packet's end
#: see zeros (bitbuffer.go:28-32).
GUARD_WORDS = 2

_BYTES_PER_SAMPLE = {16: 2, 20: 3, 24: 3, 32: 4}
#: Initial LPC coefficients for blocks the encoder's fit rejects.
_DEFAULT_COEFS = [160, 80, 40, 20, 10, 5, 3, 2] * 4

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
        lib.alac_decode_batch.restype = I32
        lib.alac_decode_batch.argtypes = [P, P, P, P, I32, P, I64, P, P, I32]
        lib.alac_encode_packet.restype = I32
        lib.alac_encode_packet.argtypes = [P, P, P, I32, P, I64]
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


def decode_batch(config, packets: Sequence[bytes]):
    """Threaded host decode: (out uint8 (B, stride), lens, errs); a nonzero
    err marks a packet the core rejected."""
    flat, offsets, sizes = _flat(packets)
    stride = config.frame_length * config.num_channels * _BYTES_PER_SAMPLE[config.bit_depth]
    out = np.zeros((len(packets), stride), dtype=np.uint8)
    lens = np.zeros(len(packets), dtype=np.int32)
    errs = np.zeros(len(packets), dtype=np.int32)
    load().alac_decode_batch(
        ctypes.byref(_config(config)), flat.ctypes.data, offsets.ctypes.data,
        sizes.ctypes.data, len(packets), out.ctypes.data, stride, lens.ctypes.data,
        errs.ctypes.data, 0,
    )
    return out, lens, errs


def encode_packets(config, pcm: np.ndarray, *, order: int = 4, mode: int = 0,
                   escape: bool = False, bytes_shifted: int = 0) -> list[bytes]:
    """Encode (n, channels) integer PCM into packets of ``frame_length``
    samples (the last one partial), with the JAX package encoder's default
    spec otherwise (den_shift 9, pb_factor 4, mix_bits 1, mix_res 1).  The
    core fits each channel's initial LPC coefficients per packet; near-white
    blocks become escape elements when that is smaller, and ``escape``
    forces them.  ``bytes_shifted`` (0..2) moves the low bytes of 24/32-bit
    samples into the shift region; the core ignores it below 24 bits and
    raises it to 1 for a 32-bit pair (native/alac_encode.cpp:292-293)."""
    if pcm.ndim != 2 or pcm.shape[1] != config.num_channels:
        raise ValueError(f"pcm must be (n, {config.num_channels}), got {pcm.shape}")
    spec = _EncSpec(
        order=order, den_shift=9, pb_factor=4, mode=mode, mix_bits=1, mix_res=1,
        bytes_shifted=bytes_shifted, force_escape=int(escape), auto_escape=1, use_lfe_tag=1,
        fit=1,
        coefs=(ctypes.c_int16 * 32)(*_DEFAULT_COEFS[: order if order < 31 else 0]),
    )
    cfg = _config(config)
    lib = load()
    out = []
    for start in range(0, pcm.shape[0], config.frame_length):
        block = np.ascontiguousarray(pcm[start : start + config.frame_length], dtype=np.int32)
        ns, channels = block.shape
        cap = ns * channels * 8 + 4096 * channels
        buf = np.empty(cap, dtype=np.uint8)
        n = lib.alac_encode_packet(
            ctypes.byref(cfg), ctypes.byref(spec), block.ctypes.data, ns, buf.ctypes.data, cap
        )
        if n < 0:
            raise ValueError(f"native encode failed with code {n}")
        out.append(buf[:n].tobytes())
    return out
