"""The port's CUDA kernels, compiled as host C++, against their plain versions.

A machine without nvcc or a card can still run each kernel's own code:
tests/cuda_host_stub.h stands in for the CUDA built-ins, every
`kernel<<<grid, block, 0, stream>>>(args)` launch is rewritten into a loop
over blocks and threads, and g++ builds csrc/*.cu into a host library whose
C entry points take CPU pointers.  Outputs start as a sentinel, so a value
the kernel fails to write shows up.  Tolerance 0 (integer code).  Skipped
only when g++ is missing.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import make_config, music_pcm

from saprobe_alac_tpu_torch import native
from saprobe_alac_tpu_torch.ops import lpc_kernel, walk_kernel
from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder
from saprobe_alac_tpu_torch.ops.raw_reader import raw_read_reference
from saprobe_alac_tpu_torch.ops.lpc import lpc_lanes
from saprobe_alac_tpu_torch.ops.walk import walk_batch

F = 256
CSRC = Path(walk_kernel.__file__).resolve().parents[1] / "csrc"
STUB = Path(__file__).resolve().parent / "cuda_host_stub.h"
SENTINEL = -0x2B2B2B2B
#: (depth, bytesShifted) of the hi-res batches.
HIRES = [(20, 0), (24, 1), (32, 1), (32, 2)]
_LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<(.*?),\s*(\w+),\s*0,.*?>>>\(", re.S)


def _host_source(text: str) -> str:
    text = text.replace("#include <cuda_runtime.h>", "")
    text, n = _LAUNCH.subn(
        r"for (blockIdx.x = 0; blockIdx.x < unsigned(\2); ++blockIdx.x) "
        r"for (threadIdx.x = 0; threadIdx.x < unsigned(\3); ++threadIdx.x) \1(",
        text,
    )
    assert n == 1, f"expected one kernel launch, rewrote {n}"
    return text


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    tmp = tmp_path_factory.mktemp("csrc_host")
    srcs = []
    for name in ("element_kernel.cu", "lpc_kernel.cu", "raw_reader_kernel.cu"):
        src = tmp / (name[:-3] + ".cpp")
        src.write_text(_host_source((CSRC / name).read_text()))
        srcs.append(str(src))
    so = tmp / "libkernels_host.so"
    cmd = ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-w", "-include", str(STUB),
           "-I", str(CSRC), "-o", str(so), *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _batch(C, seed, depth=16, bsf=0):
    """Packed batch of mixed streams and corrupted packets: a CPE tag, a CCE
    tag (unsupported element) and a truncated packet.  At 24 and 32 bits
    the music has its low ``bsf`` bytes in the shift region (32-bit music is
    24-bit content: at full scale every packet would be an escape)."""
    cfg = make_config(depth=depth, channels=C, frame_length=F)
    quiet = 8 if depth == 32 else 0
    pk = []
    for i, (kw, ton) in enumerate([
        ({}, 0.98), ({}, 0.0), ({"order": 12}, 0.98), ({"order": 31, "mode": 1}, 0.98),
        ({"escape": True}, 0.9), ({"order": 30, "mode": 2}, 0.98),
    ]):
        pcm = music_pcm(3 * F - 37, C, depth, seed=seed + i, tonality=ton)
        pk += native.encode_packets(cfg, pcm >> (quiet if ton else 0), bytes_shifted=bsf, **kw)
    pk += [b"\x20" + pk[0][1:], b"\x40" + pk[2][1:], pk[1][:5]]
    words, sizes = TorchBatchDecoder(cfg, "cpu")._stage(pk)
    return cfg, words, sizes


def _cases(*lists):
    """pytest params over (depth, bsf) x the other axes: the 16-bit cases
    keep ids of the other axes alone, the hi-res ones lead with depth-bsf."""
    out = []
    for depth, bsf in [(16, 0), *HIRES]:
        for rest in lists:
            ids = "-".join(str(x) for x in rest)
            ids = ids if depth == 16 else f"{depth}-{bsf}-{ids}"
            out.append(pytest.param(depth, bsf, *rest, id=ids))
    return out


@pytest.mark.parametrize("depth,bsf,C", _cases((1,), (2,)))
def test_element_kernel_host_matches_plain(host_lib, depth, bsf, C):
    """At every depth: chan_bits from depth and bytesShifted, the shift
    region skipped, escapes, and the corrupted packets' error codes."""
    cfg, words, sizes = _batch(C, 10 * C + depth - 16, depth, bsf)
    B, W = words.shape
    i32 = torch.int32
    args = (
        words, torch.zeros(B, dtype=i32), (sizes > 0).to(i32), sizes,
        torch.full((B,), F, dtype=i32), torch.full((B,), int(C > 1), dtype=i32),
    )
    kw = dict(kb=cfg.kb, F=F, depth=depth, pb_cfg=cfg.pb, mb_cfg=cfg.mb, passes=C)
    want = walk_kernel.dense_element_reference(*args, **kw)
    got = [torch.full_like(x, SENTINEL) for x in want]
    rc = host_lib.alac_element_launch(
        _ptr(words), W, *(_ptr(t) for t in args[1:]), *(_ptr(t) for t in got),
        B, F, walk_kernel.f_pad(F), C, cfg.kb, depth, cfg.pb, cfg.mb, None,
    )
    assert rc == 0
    assert int((want[2] != 0).sum()) >= 2  # the corrupted packets flag errors
    meta, ok = want[3], want[2] == 0
    assert (meta[walk_kernel.M_BSF][ok] == bsf).any() and (meta[walk_kernel.M_ESC][ok] == 1).any()
    for name, g, w in zip(("rows", "bitpos", "err", "meta"), got, want):
        assert torch.equal(g, w), f"{name} differs at {torch.nonzero(g != w)[:5].tolist()}"


@pytest.mark.parametrize("depth,bsf,taps,C", _cases((9, 1), (9, 2), (32, 1), (32, 2)))
def test_lpc_kernel_host_matches_plain(host_lib, depth, bsf, taps, C):
    cfg, words, sizes = _batch(C, 20 * C + taps + depth - 16, depth, bsf)
    w = walk_batch(words, sizes, F=F, C=C, depth=depth, pb=cfg.pb, mb=cfg.mb, kb=cfg.kb)
    assert {0, 4, 12, 30, 31} <= set(np.unique(w.order.numpy()).tolist())
    assert (w.cb == depth - 8 * bsf + (C > 1)).any()  # compressed lanes' chan_bits
    L = words.shape[0] * C
    lanes = lpc_lanes(
        w.order.T.reshape(L), w.mode.T.reshape(L), w.den.T.reshape(L),
        w.cb.T.reshape(L), w.ns.repeat(C), w.coefs.transpose(0, 1).reshape(L, 32),
    )
    want = lpc_kernel.lpc_fir_reference(w.res, *lanes, F=F, taps=taps)
    got = torch.full_like(want, SENTINEL)
    P, F_src, S = w.res.shape
    coefs_t = lanes[-1][:, :taps].T.contiguous()
    rc = getattr(host_lib, f"alac_lpc_launch_{taps}")(
        _ptr(w.res), S, F_src, *(_ptr(t) for t in lanes[:-1]), _ptr(coefs_t), _ptr(got),
        walk_kernel.f_pad(F), L, None,
    )
    assert rc == 0
    assert torch.equal(got, want), f"differs at {torch.nonzero(got != want)[:5].tolist()}"


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("width", [8, 16, 24, 32, "mixed"])
def test_raw_reader_kernel_host_matches_plain(host_lib, width, signed):
    """Random words; steps of 1-2 field widths; inactive lanes, n from 0 to
    past F, fields running past the last column, F not a multiple of 16 and
    a lane count not a multiple of the block."""
    B, W, Fr = 200, 420, 200
    rng = np.random.default_rng(7 + signed)
    i32 = np.int32
    words = rng.integers(-(2**31), 2**31, size=(B, W), dtype=np.int64).astype(i32)
    widths = (rng.integers(1, 33, size=B) if width == "mixed" else np.full(B, width)).astype(i32)
    step = (widths * rng.integers(1, 3, size=B)).astype(i32)
    n = rng.integers(0, Fr + 20, size=B).astype(i32)
    act = (rng.random(B) < 0.8).astype(i32)
    base = rng.integers(0, 64, size=B)
    base[:8] = W * 32 - np.minimum(n[:8], Fr) * step[:8] + rng.integers(-40, 10, size=8)
    base = np.maximum(base, 0).astype(i32)
    args = [torch.from_numpy(x) for x in (words, base, step, widths, act, n)]
    want = raw_read_reference(*args, F=Fr, signed=signed)
    got = torch.full_like(want, SENTINEL)
    rc = host_lib.alac_raw_read_launch(
        _ptr(args[0]), W, *(_ptr(t) for t in args[1:]), _ptr(got), B, want.shape[0],
        int(signed), None,
    )
    assert rc == 0
    assert want.any() and (want[:Fr] != 0).sum(0).max() > 100
    assert torch.equal(got, want), f"differs at {torch.nonzero(got != want)[:5].tolist()}"
