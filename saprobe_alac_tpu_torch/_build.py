"""Build and load the port's native libraries at first use.

Two shared libraries with a plain C interface, loaded with ctypes:

- ``libalac_kernels.so``: the hand-written CUDA kernels (csrc/), compiled by
  ``nvcc`` for ``sm_90a``;
- ``libalac_host.so``: the repo's C++ host core (native/alac_core.cpp and
  alac_encode.cpp), compiled by ``g++``; see ``native.py``.

Each build is keyed on a content hash of its sources and its command (git
does not keep mtimes), lands in ``_build/`` beside this file, and holds a
file lock so concurrent processes build once.  A missing compiler or a
failed build raises; nothing falls back to another path.

Each kernel wrapper bumps its entry in the launch counters right where it
launches, so a run can show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_OUT = _PKG / "_build"
_KERNEL_SOURCES = ("alac_int.cuh", "element_kernel.cu", "lpc_kernel.cu")

_lock = threading.Lock()
_lib = None

#: Launches per kernel since the last reset (plain integers).
_launches = {"element": 0, "lpc": 0}


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def build_library(stem: str, sources: list[Path], argv) -> Path:
    """``_build/<stem>.so``, rebuilt by ``argv(out_path)`` when the sources
    or the command changed.  The compiler's output goes to ``<stem>.log``."""
    _OUT.mkdir(parents=True, exist_ok=True)
    so, stamp, log = (_OUT / f"{stem}{ext}" for ext in (".so", ".sha256", ".log"))
    h = hashlib.sha256(" ".join(argv(so)).encode())
    for src in sources:
        h.update(src.read_bytes())
    digest = h.hexdigest()
    with open(_OUT / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists() and stamp.exists() and stamp.read_text() == digest:
            return so
        tmp = _OUT / f"{stem}.{os.getpid()}.tmp.so"
        proc = subprocess.run(argv(tmp), capture_output=True, text=True, timeout=600)
        log.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"building {stem} failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
        stamp.write_text(digest)
    return so


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _kernels_argv(out: Path) -> list[str]:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out),
        str(_CSRC / "element_kernel.cu"), str(_CSRC / "lpc_kernel.cu"),
    ]


def build_log() -> str:
    """The compiler's output of the last kernel build (register and spill
    report)."""
    log = _OUT / "libalac_kernels.log"
    return log.read_text() if log.exists() else ""


def load():
    """The loaded kernel library; builds it first when the sources changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = build_library(
            "libalac_kernels", [_CSRC / n for n in _KERNEL_SOURCES], _kernels_argv
        )
        lib = ctypes.CDLL(str(so))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.alac_element_launch.restype = I
        lib.alac_element_launch.argtypes = [
            P, I, P, P, P, P, P,  # words, W, bitpos, pact, size_bits, ns, allow_cpe
            P, P, P, P,  # rows, bitpos_out, err, meta
            I, I, I, I, I, I, I, I,  # B, F, F_pad, passes, kb, depth, pb, mb
            P,  # stream
        ]
        for taps in (9, 32):
            fn = getattr(lib, f"alac_lpc_launch_{taps}")
            fn.restype = I
            fn.argtypes = [
                P, I, I,  # res, src_stride, src_rows
                P, P, P, P, P, P, P, P,  # fir, order, den, cb, ns, wrap16, mode, coefs_t
                P, I, I,  # out, F_pad, L
                P,  # stream
            ]
        _lib = lib
        return _lib
