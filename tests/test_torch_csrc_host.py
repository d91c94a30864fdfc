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
from saprobe_alac_tpu_torch.codec.element import CHANNEL_LAYOUT_OFFSETS
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
        r"for (blockDim.x = unsigned(\3), blockIdx.x = 0; blockIdx.x < unsigned(\2); ++blockIdx.x) "
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
    words = args[0]
    B, W = words.shape
    rc = host_lib.alac_dense_entropy_launch(
        _ptr(words), W, *(_ptr(t) for t in args[1:]), *(_ptr(t) for t in got),
        B, walk_kernel.f_pad(entropy_cases.F), kw["passes"], kw["kb"],
        None,
    )
    assert rc == 0
    assert want[0].any()
    for field, g, w in zip(("rows", "bitpos", "err"), got, want):
        assert torch.equal(g, w), f"{field} differs at {torch.nonzero(g != w)[:5].tolist()}"


def _entropy_edge(name):
    """dense_entropy inputs at an edge of the walk loop (B=128 lanes of
    F=64 rows, one pass): (arguments, keywords, what the case must show)."""
    B, Fe, ec = entropy_cases.B, entropy_cases.F, entropy_cases
    kind, _, arg = name.partition("-")
    seed = sorted(ENTROPY_EDGES).index(name)
    rng = np.random.default_rng(500 + seed)
    ns = ec.lane_counts()
    kb, cb, mb = 14, 17, np.full(B, ec.MB, np.int32)
    start = np.zeros(B, np.int64)
    res = ec.residual_lanes(seed, cb)
    if kind == "lastword":
        ns = np.minimum(ns, 40)
    if kind == "straddle":  # every start phase 0..127: codewords across every bit of a word
        start = np.arange(B, dtype=np.int64)
        res = rng.integers(-60, 60, (B, Fe))
    elif kind == "escape":  # suffixes of max_size bits, values over 0xFFFF saturating the mean
        cb = int(arg)
        half = 1 << (cb - 1)
        res = rng.integers(-half + 1, half, (B, Fe))
        res[::4] = rng.integers(-60, 60, (B // 4, Fe))
    elif kind == "kb":
        kb = int(arg)
    if kind in ("zerorun", "fuzz"):
        # Streams written bit by bit: a 0 codeword (mb 0: k 1, value 0, so
        # the mean stays 0 and a zero run starts), then a 9-one run code
        # with a 16-bit count, then random bits; or random bits alone.
        bits = rng.integers(0, 2, (B, 40 * Fe)).astype(np.uint8)
        if kind == "zerorun":
            mb[:] = 0
            for b in range(B):
                run = (65535, 65535, 65534, 1)[b % 4]
                bits[b, :26] = [0] + [1] * 9 + [int(c) for c in format(run, "016b")]
            ns[:] = 65535 + np.array([1, 0, 64, 2])[np.arange(B) % 4]  # 65535 + 1 > 65535: ERR_SAMPLES
        else:
            mb = np.array([0, 10, 0xFFFF, 0x40000000, 0x7FFFFFF0] * B, np.int32)[:B]
            ns[::3] = 0x7FFFFFFF
        words = np.packbits(bits, axis=1).view(">u4").astype(np.uint32).view(np.int32)
        sizes = np.full(B, bits.shape[1], np.int64)
        max_size = rng.integers(0, 33, B).astype(np.int32)
    else:
        streams, nbits = ec.port_streams(res, ns, 40, cb, kb)
        prefix = [rng.integers(0, 2, int(n)).astype(np.uint8) for n in start]
        words = ec.pack_bits([prefix, streams])
        sizes = start + nbits
        max_size = np.full(B, cb, np.int32)
        if kind == "lastword":
            # The longest stream ends in the row's last word, and every lane
            # walks past its stream (ns 64 rows, at most 40 codewords
            # written) and claims 64 bits more: the reads past the row see
            # zeros, not the next row.
            words = words[:, : (int(sizes.max()) + 31) // 32]
            sizes = sizes + 64
            ns = np.full(B, Fe, np.int32)
        elif kind == "width":  # W % 4 == 1, 2, 3
            words = np.pad(words, ((0, 0), (0, (int(arg) - words.shape[1]) % 4)))
            assert words.shape[1] % 4 == int(arg)
    i32 = np.int32
    ones = np.ones(B, i32)
    args = (words, start.astype(i32), ones, ones * 40, max_size, ns.astype(i32),
            sizes.astype(i32), mb, ones, ones * 40)
    return entropy_cases.torch_args(args), dict(kb=kb, F=Fe, passes=1)


ENTROPY_EDGES = ("straddle", "lastword", "escape-16", "escape-24", "escape-32", "zerorun",
                 "fuzz", "kb-1", "kb-14", "kb-31", "width-1", "width-2", "width-3")


@pytest.mark.parametrize("name", ENTROPY_EDGES)
def test_walk_loop_edges_host_match_plain(host_lib, name):
    """The walk loop of the three walk kernels (dense_entropy runs it alone)
    at the edges of its design: codewords across every bit of a word, a
    stream running to the row's last word and reads past it, escape
    suffixes of 16, 24 and 32 bits (the mean saturating at 0xFFFF), zero
    runs of 65,535 (the longest count a run code holds) with ns too short
    for one, random bits with means from 0 to 2^31 - 16 (runs of any
    length, wrapped counts), kb 1, 14 and 31, and W % 4 == 1, 2, 3.  Every
    output of every lane equal to the plain version's."""
    args, kw = _entropy_edge(name)
    want = walk_kernel.dense_entropy_reference(*args, **kw)
    got = [torch.full_like(x, SENTINEL) for x in want]
    words = args[0]
    B, W = words.shape
    rc = host_lib.alac_dense_entropy_launch(
        _ptr(words), W, *(_ptr(t) for t in args[1:]), *(_ptr(t) for t in got),
        B, walk_kernel.f_pad(kw["F"]), kw["passes"], kw["kb"], None,
    )
    assert rc == 0
    rows, err = want[0], want[2]
    assert rows.any()
    if name == "zerorun":
        assert int((err == walk_kernel.ERR_SAMPLES).sum()) == entropy_cases.B // 4
    if name in ("fuzz", "lastword"):
        assert int((err == 0).sum()) >= 8
    if name.startswith("escape"):
        assert int(rows.abs().max()) > 0xFFFF or name == "escape-16"
    for field, g, w in zip(("rows", "bitpos", "err"), got, want):
        assert torch.equal(g, w), f"{field} differs at {torch.nonzero(g != w)[:5].tolist()}"


def test_walk_loop_long_zero_runs_host_match_plain(host_lib):
    """Zero runs of 65,535 that end inside the pass (F = 65,600 rows, 8
    lanes): after such a run the next codeword takes no zmode bias, after a
    shorter one it does; then random bits.  Every output equal to the plain
    version's."""
    B, Fe = 8, 65600
    rng = np.random.default_rng(77)
    bits = rng.integers(0, 2, (B, 2048)).astype(np.uint8)
    for b in range(B):
        run = (65535, 65534, 65535, 60000)[b % 4]
        # a 0 codeword (mb 0: k 1, value 0), the 9-one run code and its count
        bits[b, :26] = [0] + [1] * 9 + [int(c) for c in format(run, "016b")]
    words = np.packbits(bits, axis=1).view(">u4").astype(np.uint32).view(np.int32)
    i32 = np.int32
    ones = np.ones(B, i32)
    args = entropy_cases.torch_args((
        words, np.zeros(B, i32), ones, ones * 40, ones * 17, np.full(B, Fe, i32),
        np.full(B, bits.shape[1], i32), np.zeros(B, i32), ones, ones * 40))
    kw = dict(kb=14, F=Fe, passes=1)
    want = walk_kernel.dense_entropy_reference(*args, **kw)
    got = [torch.full_like(x, SENTINEL) for x in want]
    rc = host_lib.alac_dense_entropy_launch(
        _ptr(args[0]), words.shape[1], *(_ptr(t) for t in args[1:]), *(_ptr(t) for t in got),
        B, walk_kernel.f_pad(Fe), 1, 14, None,
    )
    assert rc == 0
    # Three of the lanes with a 65,535 run decode codewords after it.
    assert want[0][0, 65536:, [0, 2, 4]].any(axis=0).all()
    for field, g, w in zip(("rows", "bitpos", "err"), got, want):
        assert torch.equal(g, w), f"{field} differs at {torch.nonzero(g != w)[:5].tolist()}"


@pytest.mark.parametrize("depth", [16, 24, 32])
def test_raw_lanes_host_match_plain(host_lib, depth):
    """Escape (raw) packets, which raw_pass walks off the codeword loop: mono
    and stereo at 16, 24 and 32 bits, full, partial and truncated packets,
    through the packet kernel and the element kernel."""
    for C in (1, 2):
        cfg = make_config(depth=depth, channels=C, frame_length=F)
        pcm = music_pcm(3 * F - 37, C, min(depth, 24), seed=depth + C)
        pk = native.encode_packets(cfg, pcm, escape=True)
        pk += [pk[0][: len(pk[0]) // 2]]
        words, sizes = TorchBatchDecoder(cfg, "cpu")._stage(pk)
        B, W = words.shape
        offsets = torch.tensor(CHANNEL_LAYOUT_OFFSETS[C - 1], dtype=torch.int32)
        kw = dict(kb=cfg.kb, F=F, C=C, depth=depth, pb_cfg=cfg.pb, mb_cfg=cfg.mb)
        want = walk_kernel.dense_packet_reference(words, sizes, offsets, **kw)
        got = [torch.full_like(x, SENTINEL) for x in want]
        rc = host_lib.alac_packet_launch(
            _ptr(words), W, _ptr(sizes), _ptr(offsets), *(_ptr(t) for t in got),
            B, C, F, walk_kernel.f_pad(F), cfg.kb, depth, cfg.pb, cfg.mb, None,
        )
        assert rc == 0
        esc = want[3][walk_kernel.PACKET_FIELDS.index("esc")]
        assert int(esc[:, 0].sum()) >= 3 and int(want[1][len(pk) - 1]) != 0
        for name, g, w in zip(("rows", "err", "ns", "meta", "coefs"), got, want):
            assert torch.equal(g, w), f"C={C} {name} differs at {torch.nonzero(g != w)[:5].tolist()}"


#: The orders with a body of their own in csrc/lpc_kernel.cu, and the lanes
#: of a warp.
SPECIAL_ORDERS = (4, 5, 6, 8)
GROUP = 32


def _group_lanes(taps, kind, seed, forward):
    """LPC kernel inputs in groups of 32 lanes (a warp each):
    [rows (1, F_pad, L), fir, order, den, cb, ns, wrap16, mode, coefs].

    "uniform": one group at each of orders 4, 5, 6 and 8 in which every lane
    is class 1 at that order (a specialized body), then 20 lanes at order 4
    (L not a multiple of 32: a partial last group).  "mixed": orders 4, 8,
    5, 6 in turn (each lane its own order's body), then groups that take
    the general loop: order 4 with one class-0 lane, order 8 with one
    class-2 lane, order 6 with one lane of chan bits 33 (sext gives 0),
    order 5 with one int16-wrapped lane, the orders without a body of their
    own, then 13 lanes.  Within every group: mode 0
    and 1, chan bits 16, 17, 24 and 32, full, partial, one-sample and empty
    packets, den 0 to 15 and the counts 33 and -1 (sign fill), full-scale
    32-bit noise.  The rows are music (the signal in the forward direction;
    in decode, its forward residuals, as a stream carries them)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        order = np.concatenate([np.full(GROUP, o) for o in SPECIAL_ORDERS] + [np.full(20, 4)])
    else:
        others = [1, 2, 3, 7, 9, 12] + ([17, 30] if taps == 32 else [])
        groups = [np.resize([4, 8, 5, 6], GROUP)] + [np.full(GROUP, o) for o in (4, 8, 6, 5)]
        groups.append(np.resize(others, GROUP))
        order = np.concatenate(groups + [np.resize(others, 13)])
    L = order.size
    i = np.arange(L) % GROUP
    fir = np.ones(L, np.int32)
    cb = np.array([16, 17, 24, 32])[i % 4]
    mode = (i // 4) % 2
    ns = np.full(L, F)
    ns[i == 3] = rng.integers(2, F, size=int((i == 3).sum()))
    ns[i == 5], ns[i == 9] = 0, 1
    den = np.array([9, 0, 15, 12])[(i // 8) % 4]
    den[i == 13], den[i == 14] = 33, -1
    wrap16 = (~np.isin(order, SPECIAL_ORDERS)).astype(np.int32)
    if kind == "mixed":
        fir[GROUP + 11] = 0
        fir[2 * GROUP + 6], order[2 * GROUP + 6], den[2 * GROUP + 6] = 2, 1, 0
        cb[3 * GROUP + 2] = 33
        wrap16[4 * GROUP + 10] = 1
    x = np.zeros((F, L), np.int64)
    for l in range(L):
        x[:, l] = music_pcm(F, 1, min(int(cb[l]), 24), seed=seed + l, tonality=0.9)[:, 0]
    noisy = (cb == 32) & (i % 8 == 7)
    x[:, noisy] = rng.integers(-(2**31), 2**31, size=(F, int(noisy.sum())))
    coefs = np.zeros((L, 32), np.int32)
    for l in range(L):
        coefs[l, : order[l]] = rng.integers(-2000, 2000, size=order[l])
    coefs[fir == 2, 0] = 1
    rows = np.zeros((1, walk_kernel.f_pad(F), L), np.int32)
    rows[0, :F] = x.astype(np.int32)
    lanes = [torch.from_numpy(np.asarray(a, np.int32)) for a in
             (rows, fir, order, den, cb, ns, wrap16, mode, coefs)]
    # The bodies each group runs (csrc/lpc_kernel.cu `group_body`; 0 the
    # general loop): its lanes' own when every lane has one, else 0.
    special = (fir == 1) & np.isin(order, SPECIAL_ORDERS) & (wrap16 == 0) & (cb >= 1) & (cb <= 32)
    bodies = [sorted(set(order[g : g + GROUP])) if special[g : g + GROUP].all() else [0]
              for g in range(0, L, GROUP)]
    want = ([[o] for o in order[::GROUP]] if kind == "uniform"
            else [list(SPECIAL_ORDERS)] + [[0]] * 6)
    assert bodies == want, f"groups run bodies {bodies}, the case wants {want}"
    if not forward:
        lanes[0] = lpc_kernel.lpc_fir_reference(*lanes, F=F, taps=taps, forward=True)[None]
    return lanes


def _host_lpc(host_lib, res, lanes, taps, forward):
    """The LPC kernel's output as host C++, every row (F_pad, L)."""
    P, F_src, S = res.shape
    L = P * S
    got = torch.full((walk_kernel.f_pad(F), L), SENTINEL, dtype=torch.int32)
    coefs_t = lanes[-1][:, :taps].T.contiguous()
    rc = getattr(host_lib, f"alac_lpc_{'fwd_' if forward else ''}launch_{taps}")(
        _ptr(res), S, F_src, *(_ptr(t) for t in lanes[:-1]), _ptr(coefs_t), _ptr(got),
        walk_kernel.f_pad(F), L, None,
    )
    assert rc == 0
    return got


GROUP_KINDS = ("uniform", "mixed")


@pytest.mark.parametrize(
    "depth,bsf,taps,C",
    _cases((9, 1), (9, 2), (32, 1), (32, 2))
    + [pytest.param(None, None, taps, kind, id=f"{taps}-{kind}")
       for taps in (9, 32) for kind in GROUP_KINDS],
)
def test_lpc_kernel_host_matches_plain(host_lib, depth, bsf, taps, C):
    """Decode direction.  C: the channels of a walked batch of mixed orders,
    or the kind of synthetic 32-lane groups (`_group_lanes`): the
    order-specialized bodies and the general loop beside them."""
    if isinstance(C, str):
        res, *lanes = _group_lanes(taps, C, 700 + taps + 10 * GROUP_KINDS.index(C), False)
    else:
        cfg, words, sizes = _batch(C, 20 * C + taps + depth - 16, depth, bsf)
        w = walk_batch(words, sizes, F=F, C=C, depth=depth, pb=cfg.pb, mb=cfg.mb, kb=cfg.kb)
        assert {0, 4, 12, 30, 31} <= set(np.unique(w.order.numpy()).tolist())
        assert (w.cb == depth - 8 * bsf + (C > 1)).any()  # compressed lanes' chan_bits
        L = words.shape[0] * C
        res, lanes = w.res, lpc_lanes(
            w.order.T.reshape(L), w.mode.T.reshape(L), w.den.T.reshape(L),
            w.cb.T.reshape(L), w.ns.repeat(C), w.coefs.transpose(0, 1).reshape(L, 32),
        )
    want = lpc_kernel.lpc_fir_reference(res, *lanes, F=F, taps=taps)
    got = _host_lpc(host_lib, res, lanes, taps, False)
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
        _ptr(args[0]), W, B, None, *(_ptr(t) for t in args[1:]), _ptr(got), B, want.shape[0],
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


@pytest.mark.parametrize(
    "taps,groups",
    [pytest.param(9, None, id="9"), pytest.param(32, None, id="32")]
    + [pytest.param(taps, kind, id=f"{taps}-{kind}") for taps in (9, 32) for kind in GROUP_KINDS],
)
def test_lpc_forward_kernel_host_matches_plain(host_lib, taps, groups):
    """Forward direction: one regime per group of 8 lanes (`_forward_lanes`),
    or synthetic 32-lane groups (`_group_lanes`)."""
    if groups is None:
        lanes = _forward_lanes(taps, 300 + taps)
    else:
        lanes = _group_lanes(taps, groups, 800 + taps + 10 * GROUP_KINDS.index(groups), True)
    want = lpc_kernel.lpc_fir_reference(*lanes, F=F, taps=taps, forward=True)
    rows = lanes[0]
    got = _host_lpc(host_lib, rows, lanes[1:], taps, True)
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
        _ptr(args[0]), _ptr(args[1]), None, B, *(_ptr(t) for t in args[2:]), _ptr(words),
        _ptr(bits), _ptr(ovf), B, F, W, kb, None
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
        _ptr(args[0]), _ptr(args[1]), None, B, *(_ptr(t) for t in args[2:]), _ptr(words),
        _ptr(bits), _ptr(ovf), B, F, W, 14, None
    )
    assert rc == 0 and ovf.any() and not ovf.all()
    assert torch.equal(bits, want[1]) and torch.equal(ovf, want[2])
    assert not words[B * W :].any()
    fits = ovf == 0
    assert torch.equal(words[: B * W].view(B, W)[fits], want[0][fits])


@pytest.fixture(scope="module")
def quotient_lib(tmp_path_factory):
    """The encode kernel's source as host C++ with one more entry point:
    the mismatches of its divide-free quotient against a divide."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    tmp = tmp_path_factory.mktemp("quotient_host")
    src = tmp / "quotient.cpp"
    src.write_text(_host_source((CSRC / "encode_kernel.cu").read_text()) + """
extern "C" int64_t quotient_misses(int32_t j, const uint32_t* v, int64_t n) {
  const uint32_t m = (1u << j) - 1u;
  int64_t bad = 0;
  for (int64_t i = 0; i < n; ++i) bad += rice_quotient(v[i], j) != v[i] / m;
  return bad;
}
""")
    so = tmp / "libquotient.so"
    cmd = ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-w", "-include", str(STUB),
           "-I", str(CSRC), "-o", str(so), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.quotient_misses.restype = ctypes.c_int64
    lib.quotient_misses.argtypes = [ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64]
    return lib


@pytest.mark.parametrize("j", range(1, 24))
def test_encode_quotient_is_exact_below_nine(quotient_lib, j):
    """`rice_quotient(v, j)` == v / (2^j - 1) wherever the encoder uses it
    (v < 9 (2^j - 1); j = k <= 23 for a sample, j <= 17 for a zero run):
    every such v for j <= 18, the edges of each quotient and 2 M random
    values beyond."""
    m = (1 << j) - 1
    if j <= 18:
        v = np.arange(9 * m, dtype=np.uint32)
    else:
        rng = np.random.default_rng(j)
        edges = np.arange(10)[:, None] * m + np.arange(-3, 4)[None, :]
        v = np.concatenate([edges.ravel(), rng.integers(0, 9 * m, 2_000_000)])
        v = v[(v >= 0) & (v < 9 * m)].astype(np.uint32)
    assert quotient_lib.quotient_misses(j, v.ctypes.data, v.size) == 0


def _host_encode(host_lib, args, kb, W, row=None, R=None):
    """The encode kernel on the host: (words, bits, ovf) of args' lanes."""
    L = args[2].shape[0]
    words = torch.zeros((L, W), dtype=torch.int32)  # the wrapper's zeroed buffer
    bits = torch.full((L,), SENTINEL, dtype=torch.int32)
    ovf = torch.full((L,), SENTINEL, dtype=torch.int32)
    rc = host_lib.alac_encode_launch(
        _ptr(args[0]), _ptr(args[1]), None if row is None else _ptr(row),
        L if R is None else R, *(_ptr(t) for t in args[2:]), _ptr(words), _ptr(bits),
        _ptr(ovf), L, F, W, kb, None,
    )
    assert rc == 0
    return words, bits, ovf


@pytest.mark.parametrize("kb", [2, 3, 5, 17, 31, 32])
def test_encode_kernel_host_zero_run_divisors(host_lib, kb):
    """Zero-run codewords whose divisor is masked by kb (k32 = 8 > kb once
    the mean is 0) and whose divisor is 2^31 - 1 or all ones (a mean that
    wrapped: k32 past 32, j = kb; at kb 32 the divisor reads as -1 and
    forces the escape), their k32-wide suffix clamped to 32 bits: pbFactor 0
    keeps the mean where mb puts it."""
    rng = np.random.default_rng(2000 + kb)
    B = 48
    res = np.where(rng.random((B, F)) < 0.6, 0, rng.integers(-20, 20, (B, F)))
    res[40:] = 0
    ns = np.full(B, F, np.int32)
    zrun = _zero_run_table(torch.from_numpy(res.astype(np.int32)), torch.from_numpy(ns)).numpy()
    pb = np.where(np.arange(B) < 32, 0, 40).astype(np.int32)
    args = list(encode_inputs_from_jax(res, zrun, pb, 17, ns, 10))
    mb = np.full(B, 10, np.int32)
    mb[8:32] = np.tile(np.array([0x40000010, -0x7FFFFFE0, -0x40000000], np.int64), 8)
    args[6] = torch.from_numpy(mb.astype(np.int32))
    W = (F * (9 + max(kb, 17) + 26) + 256) // 32 + 4
    want = encode_kernel.dense_encode_reference(*args, kb=kb, F=F, W_out=W)
    got = _host_encode(host_lib, args, kb, W)
    assert not want[2].any() and (want[1] > 0).all()
    for name, g, w in zip(("words", "bits", "ovf"), got, want):
        assert torch.equal(g, w), f"{name} differs at {torch.nonzero(g != w)[:5].tolist()}"


@pytest.mark.parametrize("cands", [(4, 10), (2, 4, 7)])
def test_encode_kernel_host_one_launch_per_element(host_lib, cands):
    """One launch for two channels under two or three pbFactor candidates,
    lanes candidate-major then channel, each reading its channel's row
    through the row map: equal to the plain version with the same map, and
    lane by lane to the plain version of each channel alone under its
    candidate's pb_local."""
    from saprobe_alac_tpu_torch.ops.encode_device import _element_entropy_args

    res_list, ns = [], None
    for c in range(2):
        res, ns_np, _ = _encode_lanes(3000 + c, 17)
        res_list.append(torch.from_numpy(res.astype(np.int32)))
        ns = torch.from_numpy(ns_np)
    B = ns.shape[0]
    pb_locals = [torch.full((B,), (40 * p) // 4, dtype=torch.int64) for p in cands]
    args, row = _element_entropy_args(res_list, ns, pb_locals, 17, 10)
    args = list(args)
    args[2] = args[2].clone()
    args[2][[7, B + 70, 2 * B + 3]] = 0  # inactive lanes
    kb, W = 14, (F * (9 + 17 + 26) + 256) // 32 + 4
    want = encode_kernel.dense_encode_reference(*args, kb=kb, F=F, W_out=W, row=row)
    got = _host_encode(host_lib, args, kb, W, row=row, R=2 * B)
    for name, g, w in zip(("words", "bits", "ovf"), got, want):
        assert torch.equal(g, w), f"{name} differs at {torch.nonzero(g != w)[:5].tolist()}"
    for p in range(len(cands)):
        for c in range(2):
            lanes = slice((p * 2 + c) * B, (p * 2 + c + 1) * B)
            one = [a[:, c * B : (c + 1) * B] for a in args[:2]] + [a[lanes] for a in args[2:]]
            alone = encode_kernel.dense_encode_reference(*one, kb=kb, F=F, W_out=W)
            assert all(torch.equal(g[lanes], w) for g, w in zip(got, alone))
    assert len(set(got[1].view(len(cands), 2 * B).sum(1).tolist())) == len(cands)


def _host_raw_read(host_lib, words, lanes, F_r, signed, row=None):
    """The raw reader kernel on the host: out (F_pad, L)."""
    B, W = words.shape
    L = lanes[0].shape[0]
    out = torch.full((walk_kernel.f_pad(F_r), L), SENTINEL, dtype=torch.int32)
    rc = host_lib.alac_raw_read_launch(
        _ptr(words), W, B, None if row is None else _ptr(row), *(_ptr(t) for t in lanes),
        _ptr(out), L, out.shape[0], int(signed), None,
    )
    assert rc == 0
    return out


@pytest.mark.parametrize("step", [8, 16, 24, 32, 48, 64])
def test_raw_reader_kernel_host_vector_reads(host_lib, step):
    """At each step (the vector-load forms at 8, 16 and 32, one read a
    field at every other step), signed and unsigned: widths 1..32, bases at every bit
    phase, rows of W = 421 words (so a row starts at any word of a 16-byte
    chunk), fields straddling column W - 1 and running past it, inactive
    lanes, n from 0 to past F, and a row map that repeats rows and points
    outside the batch (those lanes read zeros)."""
    Bw, W, L, Fr = 60, 421, 200, 200
    rng = np.random.default_rng(4000 + step)
    i32 = np.int32
    words = rng.integers(-(2**31), 2**31, size=(Bw, W), dtype=np.int64).astype(i32)
    widths = rng.integers(1, 33, size=L).astype(i32)
    steps = np.full(L, step, i32)
    n = rng.integers(0, Fr + 20, size=L).astype(i32)
    act = (rng.random(L) < 0.85).astype(i32)
    base = rng.integers(0, 200, size=L)
    tail = W * 32 - np.minimum(n[:16], Fr) * step + rng.integers(-40, 33, size=16)
    base[:16] = np.maximum(tail, 0)
    row = rng.integers(0, Bw, size=L)
    row[[3, 77]] = [Bw, -1]
    lanes = [torch.from_numpy(x.astype(i32)) for x in (base, steps, widths, act, n)]
    w_t, row_t = torch.from_numpy(words), torch.from_numpy(row.astype(i32))
    for signed in (False, True):
        want = raw_read_reference(w_t, *lanes, F=Fr, signed=signed, row=row_t)
        got = _host_raw_read(host_lib, w_t, lanes, Fr, signed, row=row_t)
        assert (want[:Fr] != 0).sum(0).max() > 100 and not want[:, [3, 77]].any()
        assert torch.equal(got, want), f"differs at {torch.nonzero(got != want)[:5].tolist()}"


def test_raw_reader_kernel_host_one_launch_over_channels(host_lib):
    """extract_shift's one launch over the C = 8 channel lanes of a 7.1
    batch (SCE CPE CPE CPE SCE): the V channels' lanes inactive, U lanes
    reading the pair as one field, some packets without a shift region."""
    from saprobe_alac_tpu_torch.ops.epilogue import shift_reads

    rng = np.random.default_rng(4100)
    Bw, C, W = 96, 8, 3 * 8 * F // 4 + 40
    words = torch.from_numpy(
        rng.integers(-(2**31), 2**31, size=(Bw, W), dtype=np.int64).astype(np.int32))
    role = torch.tensor([0, 1, 2, 1, 2, 1, 2, 0], dtype=torch.int32).repeat(Bw, 1)
    bs = torch.from_numpy(rng.integers(0, 3, size=(Bw, 1)).astype(np.int32)).repeat(1, C)
    shift_base = torch.from_numpy(
        (37 + np.arange(C) * 2 * F * 8)[None, :] + rng.integers(0, 64, (Bw, 1))).to(torch.int32)
    ns = torch.from_numpy(rng.integers(0, F + 1, size=Bw).astype(np.int32))
    *lanes, row = shift_reads(shift_base, bs, role, ns)
    want = raw_read_reference(words, *lanes, F=F, row=row)
    got = _host_raw_read(host_lib, words, lanes, F, False, row=row)
    assert torch.equal(got, want), f"differs at {torch.nonzero(got != want)[:5].tolist()}"
    planes = got.view(-1, C, Bw)
    assert not planes[:, [2, 4, 6]].any() and planes[:, [0, 1, 3, 5, 7]].any(dim=(0, 2)).all()
