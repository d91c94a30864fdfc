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
from saprobe_alac_tpu_torch.encoder.spec import CHANNEL_LAYOUT_OFFSETS
from saprobe_alac_tpu_torch.interop import encode_inputs_from_jax
from saprobe_alac_tpu_torch.ops import encode_kernel, lpc_kernel, walk_kernel
from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder
from saprobe_alac_tpu_torch.ops.encode_device import _zero_run_table
from saprobe_alac_tpu_torch.ops.raw_reader import raw_read_reference
from saprobe_alac_tpu_torch.ops.lpc import lpc_lanes
from saprobe_alac_tpu_torch.ops.walk import walk_batch

import test_torch_dense_entropy as entropy_cases
import test_torch_walk_multislot as multislot

F = 256
CSRC = Path(walk_kernel.__file__).resolve().parents[1] / "csrc"
STUB = Path(__file__).resolve().parent / "cuda_host_stub.h"
SENTINEL = -0x2B2B2B2B
#: (depth, bytesShifted) of the hi-res batches.
HIRES = [(20, 0), (24, 1), (32, 1), (32, 2)]
_LAUNCH = re.compile(r"(\w+(?:<[\w, ]+>)?)<<<(.*?),\s*(\w+),\s*0,.*?>>>\(", re.S)


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
    for name in ("element_kernel.cu", "lpc_kernel.cu", "raw_reader_kernel.cu",
                 "encode_kernel.cu", "packet_kernel.cu", "dense_entropy_kernel.cu"):
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


@pytest.mark.parametrize("depth,C,bsf", multislot.CONFIGS)
def test_packet_kernel_host_matches_plain(host_lib, depth, C, bsf):
    """Every output of the packet kernel on every lane, error lanes too: the
    multi-element layouts, skips, slot budget and corrupted packets of
    tests/test_torch_walk_multislot.py, and the 16-bit batch of this file."""
    cfg = make_config(depth=depth, channels=C, frame_length=F)
    _, pkts = multislot.batch_packets(cfg, 7 * depth + C, bsf)
    if depth == 16:
        pkts = pkts + native.encode_packets(cfg, music_pcm(2 * F, C, 16, seed=C), order=12)
    words, sizes = TorchBatchDecoder(cfg, "cpu")._stage(pkts)
    B, W = words.shape
    offsets = torch.tensor(CHANNEL_LAYOUT_OFFSETS[C - 1], dtype=torch.int32)
    kw = dict(kb=cfg.kb, F=F, C=C, depth=depth, pb_cfg=cfg.pb, mb_cfg=cfg.mb)
    want = walk_kernel.dense_packet_reference(words, sizes, offsets, **kw)
    assert all(x.is_contiguous() for x in want)  # the kernel writes through raw pointers
    got = [torch.full_like(x, SENTINEL) for x in want]
    rc = host_lib.alac_packet_launch(
        _ptr(words), W, _ptr(sizes), _ptr(offsets), *(_ptr(t) for t in got),
        B, C, F, walk_kernel.f_pad(F), cfg.kb, depth, cfg.pb, cfg.mb, None,
    )
    assert rc == 0
    err = want[1]
    assert int((err == 0).sum()) >= 6 and int((err != 0).sum()) >= 3
    for name, g, w in zip(("rows", "err", "ns", "meta", "coefs"), got, want):
        assert torch.equal(g, w), f"{name} differs at {torch.nonzero(g != w)[:5].tolist()}"


@pytest.mark.parametrize("name", sorted(entropy_cases.CASES))
def test_dense_entropy_kernel_host_matches_plain(host_lib, name):
    """Rows, end cursors and error codes in every regime of
    tests/test_torch_dense_entropy.py."""
    args, kw, _ = entropy_cases.build_case(name)
    args = entropy_cases.torch_args(args)
    want = walk_kernel.dense_entropy_reference(*args, **kw)
    got = [torch.full_like(x, SENTINEL) for x in want]
    B, W = args[0].shape
    rc = host_lib.alac_dense_entropy_launch(
        _ptr(args[0]), W, *(_ptr(t) for t in args[1:]), *(_ptr(t) for t in got),
        B, walk_kernel.f_pad(entropy_cases.F), kw["passes"], kw["kb"], None,
    )
    assert rc == 0
    assert want[0].any()
    for field, g, w in zip(("rows", "bitpos", "err"), got, want):
        assert torch.equal(g, w), f"{field} differs at {torch.nonzero(g != w)[:5].tolist()}"


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


def _forward_lanes(taps, seed):
    """Forward-LPC inputs, one regime per group of lanes: every order the
    variant serves (int32 coefficients at 4, 5, 6, 8), mode 0 and 1, chan
    bits 16 to 32, full, partial and empty packets, bypass lanes (class 0),
    and full-scale noise at 32 bits (wrapping differences)."""
    rng = np.random.default_rng(seed)
    orders = [1, 2, 4, 5, 6, 8] if taps == 9 else [1, 4, 8, 9, 12, 17, 30]
    L = 8 * len(orders)
    order = np.repeat(orders, 8).astype(np.int32)
    cb = np.tile([16, 17, 24, 32], L // 4).astype(np.int32)
    mode = np.tile([0, 0, 0, 0, 1, 1, 1, 1], L // 8).astype(np.int32)
    ns = np.full(L, F, np.int32)
    ns[3::8] = rng.integers(2, F, size=L // 8)
    ns[5] = 0
    fir = np.ones(L, np.int32)
    fir[6::16] = 0
    x = np.zeros((F, L), np.int64)
    for l in range(L):
        depth = min(int(cb[l]), 24)
        x[:, l] = music_pcm(F, 1, depth, seed=seed + l, tonality=0.9)[:, 0]
    noisy = (cb == 32) & (np.arange(L) % 8 == 7)
    x[:, noisy] = rng.integers(-(2**31), 2**31, size=(F, int(noisy.sum())))
    coefs = np.zeros((L, 32), np.int32)
    for l in range(L):
        coefs[l, : order[l]] = rng.integers(-2000, 2000, size=order[l])
    rows = np.zeros((1, walk_kernel.f_pad(F), L), np.int32)
    rows[0, :F] = x.astype(np.int32)
    wrap16 = (~np.isin(order, [4, 5, 6, 8])).astype(np.int32)
    den = np.full(L, 9, np.int32)
    return [torch.from_numpy(a) for a in (rows, fir, order, den, cb, ns, wrap16, mode, coefs)]


@pytest.mark.parametrize("taps", [9, 32])
def test_lpc_forward_kernel_host_matches_plain(host_lib, taps):
    lanes = _forward_lanes(taps, 300 + taps)
    want = lpc_kernel.lpc_fir_reference(*lanes, F=F, taps=taps, forward=True)
    got = torch.full_like(want, SENTINEL)
    rows = lanes[0]
    L = rows.shape[2]
    coefs_t = lanes[-1][:, :taps].T.contiguous()
    rc = getattr(host_lib, f"alac_lpc_fwd_launch_{taps}")(
        _ptr(rows), L, rows.shape[1], *(_ptr(t) for t in lanes[1:-1]), _ptr(coefs_t), _ptr(got),
        walk_kernel.f_pad(F), L, None,
    )
    assert rc == 0
    assert (want[:F] != rows[0, :F]).any()  # residuals, not the signal passed through
    assert torch.equal(got, want), f"differs at {torch.nonzero(got != want)[:5].tolist()}"


def _encode_lanes(seed, cb):
    """Residual regimes of the entropy coder, 16 lanes each: small values
    (adaptive k), dense zero runs, all zero (the 65535-run code and zmode),
    large values (escape prefix and a cb-wide suffix), full-scale values at
    the given cb; with partial and empty packets and inactive lanes."""
    rng = np.random.default_rng(seed)
    B = 80
    res = np.zeros((B, F), np.int64)
    res[:16] = rng.integers(-50, 50, (16, F))
    res[16:32] = np.where(rng.random((16, F)) < 0.7, 0, rng.integers(-30, 30, (16, F)))
    res[48:64] = rng.integers(-(2**15), 2**15, (16, F))
    half = 1 << (cb - 1)
    res[64:] = rng.integers(-half + 1, half, (16, F))
    ns = np.full(B, F, np.int32)
    ns[[3, 20, 50]] = [17, 3, 1]
    ns[[5, 35]] = 0
    act = np.ones(B, np.int32)
    act[[7, 70]] = 0
    return res, ns, act


@pytest.mark.parametrize("kb,cb,pb,mb", [(14, 17, 40, 10), (14, 32, 40, 10), (10, 25, 10, 40),
                                         (1, 17, 40, 10), (28, 32, 40, 10), (32, 24, 40, 10)])
def test_encode_kernel_host_matches_plain(host_lib, kb, cb, pb, mb):
    res, ns, act = _encode_lanes(1000 + kb + cb, cb)
    B = res.shape[0]
    zrun = _zero_run_table(torch.from_numpy(res.astype(np.int32)), torch.from_numpy(ns)).numpy()
    args = list(encode_inputs_from_jax(res, zrun, np.full(B, pb, np.int32), cb, ns, mb))
    args[2] = torch.from_numpy(act)
    W = (F * (9 + max(kb, cb) + 26) + 256) // 32 + 4
    want = encode_kernel.dense_encode_reference(*args, kb=kb, F=F, W_out=W)
    words = torch.zeros((B, W), dtype=torch.int32)  # the wrapper's zeroed buffer
    bits = torch.full((B,), SENTINEL, dtype=torch.int32)
    ovf = torch.full((B,), SENTINEL, dtype=torch.int32)
    rc = host_lib.alac_encode_launch(
        *(_ptr(t) for t in args), _ptr(words), _ptr(bits), _ptr(ovf), B, F, W, kb, None
    )
    assert rc == 0
    assert int(want[1].max()) > 9 * F and not want[2].any()
    assert (want[1][[5, 7, 35, 70]] == 0).all()  # empty and inactive lanes emit nothing
    assert torch.equal(bits, want[1]) and torch.equal(ovf, want[2])
    assert torch.equal(words, want[0]), f"differs at {torch.nonzero(words != want[0])[:5].tolist()}"


def test_encode_kernel_host_flags_a_short_row(host_lib):
    """A row too short for the stream: nothing is stored past it, and ovf
    is set, in the kernel and in its plain version."""
    res, ns, _ = _encode_lanes(77, 17)
    B, W = res.shape[0], 40
    zrun = _zero_run_table(torch.from_numpy(res.astype(np.int32)), torch.from_numpy(ns)).numpy()
    args = encode_inputs_from_jax(res, zrun, np.full(B, 40, np.int32), 17, ns, 10)
    want = encode_kernel.dense_encode_reference(*args, kb=14, F=F, W_out=W)
    guard = 8
    words = torch.zeros((B * W + guard,), dtype=torch.int32)
    bits = torch.zeros(B, dtype=torch.int32)
    ovf = torch.zeros(B, dtype=torch.int32)
    rc = host_lib.alac_encode_launch(
        *(_ptr(t) for t in args), _ptr(words), _ptr(bits), _ptr(ovf), B, F, W, 14, None
    )
    assert rc == 0 and ovf.any() and not ovf.all()
    assert torch.equal(bits, want[1]) and torch.equal(ovf, want[2])
    assert not words[B * W :].any()
    fits = ovf == 0
    assert torch.equal(words[: B * W].view(B, W)[fits], want[0][fits])
