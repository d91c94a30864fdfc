"""The benchmark's inputs, made from the seed: music-like PCM and its ALAC
packets, as a configuration's ``music`` and ``encoder`` groups say.

`music_pcm` and `pcm_bytes` are frozen copies of chip_smoke.py at commit
d146ec009c2c24691c94e65e7d8eb983445d6db9 (its lines 282-319).  Packets
come from a frozen copy of the repo's C++ encoder (native/alac_encode.cpp at
that commit, in `native/` here), built by g++ into `_build/` beside this
file and loaded with ctypes.  Nothing here imports the system under test.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ENCODER_SOURCE = HERE / "native" / "alac_encode.cpp"
BUILD_DIR = HERE / "_build"

#: The encoder's choices where a configuration's ``encoder`` group does not
#: name them (see `EncoderSpec` of the port): order-4 LPC with per-packet
#: fitted coefficients, mode 0, den_shift 9, pbFactor 4, stereo
#: decorrelation (mix_bits 1, mix_res 1), escape only where smaller, every
#: single channel an SCE, as Apple's encoder writes the LFE;
#: ``bytes_shifted`` is the configuration's own.
ENCODER = dict(order=4, den_shift=9, pb_factor=4, mode=0, mix_bits=1, mix_res=1,
               force_escape=0, auto_escape=1, use_lfe_tag=0, fit=1)
#: The music where a configuration's ``music`` group does not say.
MUSIC = dict(tonality=0.98)
_DEFAULT_COEFS = [160, 80, 40, 20]


def music_pcm(n, channels, seed, tonality=0.98, depth=16, dev=None):
    """Music-like PCM at ``depth`` bits, an (n, channels) int64 numpy
    array: correlated tones plus low-level noise (tonality near 0 is
    near-white noise).  With ``dev`` the signal is made there in bulk, its
    noise from torch's generator; without, on the host from numpy's."""
    if dev is None:
        xp, t, rng = np, np.arange(n), np.random.default_rng(seed)
        noise = lambda: rng.standard_normal(n)  # noqa: E731
    else:
        import torch

        xp, t = torch, torch.arange(n, dtype=torch.float64, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        noise = lambda: torch.randn(n, generator=g, dtype=torch.float64, device=dev)  # noqa: E731
    cols = []
    for c in range(channels):
        tone = (
            0.35 * xp.sin(2 * np.pi * t / (97.3 + 11 * c))
            + 0.2 * xp.sin(2 * np.pi * t / (23.7 + 3 * c))
            + 0.1 * xp.sin(2 * np.pi * t / (389.0 + 29 * c))
        )
        cols.append(tonality * tone * 0.8 + (1 - tonality) * noise() * 0.5)
    scale = (1 << (depth - 1)) - 1
    if dev is None:
        return np.clip(np.stack(cols, 1) * scale, -scale - 1, scale).astype(np.int64)
    return (torch.stack(cols, 1) * scale).clamp_(-scale - 1, scale).to(torch.int64).cpu().numpy()


def pcm_bytes(pcm, depth) -> bytes:
    """The decoder's interleaved little-endian output for source PCM:
    2-byte samples at 16 bits, 3-byte at 20 (stored << 4) and 24, 4-byte at
    32 (matrix.go writers)."""
    v = pcm.astype(np.int64)
    if depth == 16:
        return v.astype("<i2").tobytes()
    if depth == 20:
        v = v << 4
    b = v.astype("<i4").view(np.uint8).reshape(-1, 4)
    return (b if depth == 32 else b[:, :3]).tobytes()


def pcm_seed(seed: int) -> int:
    """The seed as both numpy's and torch's generators take it."""
    return seed % (1 << 63)


# --- the encoder ---------------------------------------------------------


class _Config(ctypes.Structure):
    _fields_ = [(name, ctypes.c_uint32) for name in
                ("frame_length", "bit_depth", "num_channels", "pb", "mb", "kb", "max_run")]


class _Spec(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int32) for name in
                ("order", "den_shift", "pb_factor", "mode", "mix_bits", "mix_res",
                 "bytes_shifted", "force_escape", "auto_escape", "use_lfe_tag", "fit")
                ] + [("coefs", ctypes.c_int16 * 32)]


_ARGV = ["g++", "-O3", "-shared", "-fPIC", "-fwrapv"]
_lib = None


def encoder_library():
    """The frozen encoder, built at first use into `_build/` under a file
    lock, named by a hash of its source and command so a changed source is
    rebuilt and an unchanged one never is."""
    global _lib
    if _lib is not None:
        return _lib
    src = ENCODER_SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(_ARGV).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(exist_ok=True)
    out = BUILD_DIR / f"libbench_encode-{key}.so"
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            part = out.with_suffix(".part")
            subprocess.run(_ARGV + ["-o", str(part), str(ENCODER_SOURCE)], check=True,
                           capture_output=True, timeout=600)
            os.replace(part, out)
    lib = ctypes.CDLL(str(out))
    P = ctypes.c_void_p
    lib.alac_encode_packet.restype = ctypes.c_int32
    lib.alac_encode_packet.argtypes = [P, P, P, ctypes.c_int32, P, ctypes.c_int64]
    _lib = lib
    return lib


def encode(config: dict, pcm: np.ndarray, workers: int | None = None) -> list[bytes]:
    """ALAC packets of ``frame_length`` samples (the last one partial) for
    (n, channels) PCM, under `ENCODER`'s choices, encoded on ``workers``
    threads (the encoder releases the interpreter lock)."""
    lib = encoder_library()
    F, C = config["frame_length"], config["num_channels"]
    cfg = _Config(**{name: config[name] for name, _ in _Config._fields_})
    spec = _Spec(bytes_shifted=config["bytes_shifted"], **encoder_choices(config),
                 coefs=(ctypes.c_int16 * 32)(*_DEFAULT_COEFS))
    pcm32 = np.ascontiguousarray(pcm, dtype=np.int32)

    def one(start: int) -> bytes:
        block = pcm32[start : start + F]
        cap = block.shape[0] * C * 8 + 4096 * C
        buf = np.empty(cap, dtype=np.uint8)
        n = lib.alac_encode_packet(ctypes.byref(cfg), ctypes.byref(spec), block.ctypes.data,
                                   block.shape[0], buf.ctypes.data, cap)
        if n < 0:
            raise RuntimeError(f"the encoder failed with code {n} at sample {start}")
        return buf[:n].tobytes()

    starts = range(0, pcm32.shape[0], F)
    with ThreadPoolExecutor(workers or os.cpu_count() or 1) as pool:
        return list(pool.map(one, starts))


def encoder_choices(config: dict) -> dict:
    """`ENCODER` under the configuration's ``encoder`` group."""
    return dict(ENCODER, **config.get("encoder", {}))


def track(config: dict, n_samples: int, seed: int, dev=None):
    """(pcm, packets) of a seeded music track of ``n_samples`` samples, the
    music as the configuration's ``music`` group (over `MUSIC`) says."""
    music = dict(MUSIC, **config.get("music", {}))
    pcm = music_pcm(n_samples, config["num_channels"], pcm_seed(seed),
                    tonality=music["tonality"], depth=config["bit_depth"], dev=dev)
    return pcm, encode(config, pcm)
