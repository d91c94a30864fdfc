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
from saprobe_alac_tpu_torch.ops.lpc import lpc_lanes
from saprobe_alac_tpu_torch.ops.walk import walk_batch

F = 256
CSRC = Path(walk_kernel.__file__).resolve().parents[1] / "csrc"
STUB = Path(__file__).resolve().parent / "cuda_host_stub.h"
SENTINEL = -0x2B2B2B2B
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
    for name in ("element_kernel.cu", "lpc_kernel.cu"):
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


def _batch(C, seed):
    """Packed batch of mixed streams and corrupted packets: a CPE tag, a CCE
    tag (unsupported element) and a truncated packet."""
    cfg = make_config(depth=16, channels=C, frame_length=F)
    pk = []
    for i, (kw, ton) in enumerate([
        ({}, 0.98), ({}, 0.0), ({"order": 12}, 0.98), ({"order": 31, "mode": 1}, 0.98),
        ({"escape": True}, 0.9), ({"order": 30, "mode": 2}, 0.98),
    ]):
        pk += native.encode_packets(cfg, music_pcm(3 * F - 37, C, 16, seed=seed + i, tonality=ton), **kw)
    pk += [b"\x20" + pk[0][1:], b"\x40" + pk[2][1:], pk[1][:5]]
    words, sizes = TorchBatchDecoder(cfg, "cpu")._stage(pk)
    return cfg, words, sizes


@pytest.mark.parametrize("C", [1, 2])
def test_element_kernel_host_matches_plain(host_lib, C):
    cfg, words, sizes = _batch(C, seed=10 * C)
    B, W = words.shape
    i32 = torch.int32
    args = (
        words, torch.zeros(B, dtype=i32), (sizes > 0).to(i32), sizes,
        torch.full((B,), F, dtype=i32), torch.full((B,), int(C > 1), dtype=i32),
    )
    kw = dict(kb=cfg.kb, F=F, depth=16, pb_cfg=cfg.pb, mb_cfg=cfg.mb, passes=C)
    want = walk_kernel.dense_element_reference(*args, **kw)
    got = [torch.full_like(x, SENTINEL) for x in want]
    rc = host_lib.alac_element_launch(
        _ptr(words), W, *(_ptr(t) for t in args[1:]), *(_ptr(t) for t in got),
        B, F, walk_kernel.f_pad(F), C, cfg.kb, 16, cfg.pb, cfg.mb, None,
    )
    assert rc == 0
    assert int((want[2] != 0).sum()) >= 2  # the corrupted packets flag errors
    for name, g, w in zip(("rows", "bitpos", "err", "meta"), got, want):
        assert torch.equal(g, w), f"{name} differs at {torch.nonzero(g != w)[:5].tolist()}"


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("taps", [9, 32])
def test_lpc_kernel_host_matches_plain(host_lib, C, taps):
    cfg, words, sizes = _batch(C, seed=20 * C + taps)
    w = walk_batch(words, sizes, F=F, C=C, depth=16, pb=cfg.pb, mb=cfg.mb, kb=cfg.kb)
    assert {0, 4, 12, 30, 31} <= set(np.unique(w.order.numpy()).tolist())
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
