"""Build and load the port's native libraries at first use.

Shared libraries with a plain C interface, loaded with ctypes:

- ``lib<name>.so``, one per hand-written CUDA kernel (csrc/<name>.cu),
  compiled by ``nvcc`` for ``sm_90a``, all at once;
- ``libalac_host.so``: the repo's C++ host core (native/alac_core.cpp and
  alac_encode.cpp), compiled by ``g++``; see ``native.py``.

Each build is keyed on a content hash of its sources and its command (git
does not keep mtimes), lands in ``_build/`` beside this file, and holds a
file lock so concurrent processes build once.  A missing compiler or a
failed build raises; nothing falls back to another path.

Each kernel wrapper bumps its entry in the launch counters right where it
launches, so a run can show which kernels its main path went through.  A
CUDA graph replay runs no wrapper: the decode program adds the counts its
capture recorded (ops/program.py).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_OUT = _PKG / "_build"
#: One library per kernel source, each also including the shared headers.
_KERNELS = (
    "element_kernel", "lpc_kernel", "raw_reader_kernel", "encode_kernel", "packet_kernel",
    "dense_entropy_kernel",
)
_HEADERS = ("alac_int.cuh", "element_walk.cuh")

_lock = threading.Lock()
_lib = None

#: Launches per kernel since the last reset (plain integers), and
#: "replay": the decode programs' CUDA graph replays (ops/program.py).
_launches = {
    "element": 0, "lpc": 0, "raw_read": 0, "lpc_forward": 0, "encode": 0, "packet": 0,
    "dense_entropy": 0, "replay": 0,
}
#: A thread's launches go here instead while it captures a CUDA graph
#: (`recording_launches`): a capture enqueues nothing.
_recording = threading.local()


def count_launch(name: str, n: int = 1) -> None:
    rec = getattr(_recording, "counts", None)
    if rec is not None:
        rec[name] = rec.get(name, 0) + n
    else:
        _launches[name] += n


@contextlib.contextmanager
def recording_launches():
    """Within the block, this thread's `count_launch` calls fill the yielded
    dict and leave the counters alone."""
    _recording.counts = counts = {}
    try:
        yield counts
    finally:
        _recording.counts = None


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


def _kernel_argv(src: Path):
    def argv(out: Path) -> list[str]:
        return [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(_CSRC),
            "-o", str(out), str(src),
        ]

    return argv


def build_kernel(stem: str, src: Path) -> Path:
    """``_build/<stem>.so`` from one kernel source (it may include the
    shared headers of csrc/)."""
    sources = [*(_CSRC / h for h in _HEADERS), src]
    return build_library(stem, sources, _kernel_argv(src))


def _load_kernel(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_kernel(f"lib{name}", _CSRC / f"{name}.cu")))


def lpc_entry(taps: int, forward: bool) -> str:
    return f"alac_lpc_{'fwd_' if forward else ''}launch_{taps}"


def bind_lpc(lib: ctypes.CDLL) -> dict:
    """The LPC library's four entry points by name (`lpc_entry`), typed."""
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name in (lpc_entry(taps, fwd) for fwd in (False, True) for taps in (9, 32)):
        fn = getattr(lib, name)
        fn.restype = I
        fn.argtypes = [
            P, I, I,  # res, src_stride, src_rows
            P, P, P, P, P, P, P, P,  # fir, order, den, cb, ns, wrap16, mode, coefs_t
            P, I, I,  # out, F_pad, L
            P,  # stream
        ]
        fns[name] = fn
    return fns


def build_log() -> str:
    """The compiler's output of the last kernel builds (register and spill
    report)."""
    logs = [_OUT / f"lib{name}.log" for name in _KERNELS]
    return "".join(log.read_text() for log in logs if log.exists())


def load():
    """The kernel entry points; builds each kernel library first when its
    sources changed, one nvcc per source, all started together."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with ThreadPoolExecutor(len(_KERNELS)) as pool:
            libs = list(pool.map(_load_kernel, _KERNELS))
        element, lpc, raw, encode, packet, dense = libs
        P, I = ctypes.c_void_p, ctypes.c_int
        element.alac_element_launch.restype = I
        element.alac_element_launch.argtypes = [
            P, I, P, P, P, P, P,  # words, W, bitpos, pact, size_bits, ns, allow_cpe
            P, P, P, P,  # rows, bitpos_out, err, meta
            I, I, I, I, I, I, I, I,  # B, F, F_pad, passes, kb, depth, pb, mb
            P,  # stream
        ]
        raw.alac_raw_read_launch.restype = I
        raw.alac_raw_read_launch.argtypes = [
            P, I, I, P,  # words, W, B, row
            P, P, P, P, P,  # base, step, width, act, n
            P, I, I, I,  # out, L, F_pad, is_signed
            P,  # stream
        ]
        encode.alac_encode_launch.restype = I
        encode.alac_encode_launch.argtypes = [
            P, P, P, I,  # n_t, zr_t, row, R
            P, P, P, P, P,  # act, pb_local, max_size, ns, mb
            P, P, P,  # words, bits, ovf
            I, I, I, I,  # L, F, W, kb
            P,  # stream
        ]
        packet.alac_packet_launch.restype = I
        packet.alac_packet_launch.argtypes = [
            P, I, P, P,  # words, W, size_bits, offsets
            P, P, P, P, P,  # rows, err, ns, meta, coefs
            I, I, I, I, I, I, I, I,  # B, C, F, F_pad, kb, depth, pb, mb
            P,  # stream
        ]
        dense.alac_dense_entropy_launch.restype = I
        dense.alac_dense_entropy_launch.argtypes = [
            P, I, P, P, P, P, P, P, P, P, P,  # words, W, bitpos .. pb2 (nine lane vectors)
            P, P, P,  # rows, bitpos_out, err
            I, I, I, I,  # B, F_pad, passes, kb
            P,  # stream
        ]
        _lib = SimpleNamespace(
            libs=libs,
            alac_packet_launch=packet.alac_packet_launch,
            alac_dense_entropy_launch=dense.alac_dense_entropy_launch,
            alac_element_launch=element.alac_element_launch,
            alac_raw_read_launch=raw.alac_raw_read_launch,
            alac_encode_launch=encode.alac_encode_launch,
            **bind_lpc(lpc),
        )
        return _lib
