"""The port's `dense_entropy` (plain version) against the JAX package's
`dense_entropy_pallas` run in interpret mode.

Pure-entropy streams, no framing: residual rows go through an encoder (the
port's `dense_encode_reference`, the exact inverse, or the JAX package's
`ag_encode`), the words through both decoders.  Rows, end cursors and error
codes must be equal (tolerance 0), and on clean lanes the rows must be the
residuals that went in and the end cursor the encoder's bit count.  Regimes:
one pass and two (the second with its own pb), small values, dense zero runs,
all-zero lanes, escape codewords at suffix widths 17 and 32, a truncated
stream (ERR_OVERRUN), ns == 0 and partial lanes, inactive lanes in either
pass, a nonzero start cursor, kb 14 and a small kb.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saprobe_alac_tpu.codec.golomb import AGParams
from saprobe_alac_tpu.encoder.encode import ag_encode
from saprobe_alac_tpu.ops.walk_kernel import dense_entropy_pallas
from saprobe_alac_tpu_torch import interop
from saprobe_alac_tpu_torch.ops import walk_kernel
from saprobe_alac_tpu_torch.ops.encode_device import _zero_run_table
from saprobe_alac_tpu_torch.ops.encode_kernel import dense_encode_reference

F = 64
B = 128
MB = 10


def residual_lanes(seed, cb):
    """(B, F) residuals, 16 lanes a regime (twice over): small values, dense
    zero runs, all zero, large values (escape codewords), full scale at
    ``cb`` bits, long sparse runs, mixed, ones."""
    rng = np.random.default_rng(seed)
    res = np.zeros((B, F), np.int64)
    half = 1 << (cb - 1)
    for base in (0, 64):
        g = res[base : base + 64]
        g[:8] = rng.integers(-50, 50, (8, F))
        g[8:16] = np.where(rng.random((8, F)) < 0.7, 0, rng.integers(-30, 30, (8, F)))
        g[24:32] = rng.integers(-(2**15), 2**15, (8, F))
        g[32:40] = rng.integers(-half + 1, half, (8, F))
        g[40:48] = np.where(rng.random((8, F)) < 0.05, rng.integers(-9, 9, (8, F)), 0)
        g[48:56] = rng.integers(-300, 300, (8, F)) * (rng.random((8, F)) < 0.5)
        g[56:64] = 1
    return res


def lane_counts():
    ns = np.full(B, F, np.int32)
    ns[[3, 20, 50, 100]] = [17, 3, 1, 33]
    ns[[5, 35, 70]] = 0
    return ns


def port_streams(res, ns, pb, cb, kb):
    """Each lane's stream from the port's plain encoder: (bit arrays, bits)."""
    zrun = _zero_run_table(torch.from_numpy(res.astype(np.int32)), torch.from_numpy(ns)).numpy()
    args = interop.encode_inputs_from_jax(res, zrun, np.full(B, pb, np.int32), cb, ns, MB)
    W = (F * (9 + max(kb, cb) + 26) + 256) // 32 + 4
    words, bits, ovf = dense_encode_reference(*args, kb=kb, F=F, W_out=W)
    assert not ovf.any()
    bitrows = np.unpackbits(words.numpy().astype(">u4").view(np.uint8), axis=1)
    return [bitrows[b, : int(bits[b])] for b in range(B)], bits.numpy().astype(np.int64)


def jax_streams(res, ns, pb, cb, kb):
    """The same from the JAX package's scalar `ag_encode`."""
    out, bits = [], np.zeros(B, np.int64)
    for b in range(B):
        n = int(ns[b])
        if n == 0:
            out.append(np.zeros(0, np.uint8))
            continue
        ag = AGParams.standard(mb=MB, pb=pb, kb=kb, fw=n, sw=n, max_run=255)
        w = ag_encode(ag, [int(v) for v in res[b, :n]], cb)
        assert w is not None
        bits[b] = w.bit_length
        w.byte_align()
        raw = np.unpackbits(np.frombuffer(w.getvalue(), np.uint8))
        out.append(raw[: bits[b]])
    return out, bits


def pack_bits(streams):
    """Lists of per-lane bit arrays, concatenated per lane -> (B, W) int32
    big-endian words with two zero guard words."""
    joined = [np.concatenate(parts) for parts in zip(*streams)]
    W = (max(len(j) for j in joined) + 31) // 32 + 2
    bits = np.zeros((B, W * 32), np.uint8)
    for b, j in enumerate(joined):
        bits[b, : len(j)] = j
    return np.packbits(bits, axis=1).view(">u4").astype(np.uint32).view(np.int32).reshape(B, W)


#: name: (encoder, passes, kb, cb, pb, pb2, start cursors, truncated)
CASES = {
    "port-p1-kb14-cb17": ("port", 1, 14, 17, 40, 0, False, False),
    "port-p2-kb14-cb17-pb2": ("port", 2, 14, 17, 40, 24, False, False),
    "port-p1-kb14-cb32": ("port", 1, 14, 32, 40, 0, False, False),
    "port-p2-kb14-cb32-start": ("port", 2, 14, 32, 40, 16, True, False),
    "port-p2-kb6-cb17": ("port", 2, 6, 17, 40, 40, False, False),
    "port-p1-kb14-cb17-start": ("port", 1, 14, 17, 40, 0, True, False),
    "port-p2-kb14-cb17-truncated": ("port", 2, 14, 17, 40, 24, True, True),
    "jax-p1-kb14-cb17": ("jax", 1, 14, 17, 40, 0, False, False),
    "jax-p2-kb14-cb17-pb2-start": ("jax", 2, 14, 17, 40, 24, True, False),
}


def build_case(name):
    """(port arguments as numpy, keywords, expectations) of one case."""
    enc, passes, kb, cb, pb, pb2, start, truncated = CASES[name]
    seed = sorted(CASES).index(name)
    rng = np.random.default_rng(1000 + seed)
    encode = port_streams if enc == "port" else jax_streams
    ns = lane_counts()
    res = [residual_lanes(10 * seed + p, cb) for p in range(passes)]
    act = np.ones(B, np.int32)
    act[[7, 71]] = 0
    act2 = np.ones(B, np.int32)
    act2[[9, 71, 90]] = 0
    s1, bits1 = encode(res[0], ns, pb, cb, kb)
    streams, total = [s1], bits1.copy()
    if passes == 2:
        s2, bits2 = encode(res[1], ns, pb2, cb, kb)
        streams.append(s2)
        total += bits2
    bitpos = rng.integers(0, 300, B) if start else np.zeros(B, np.int64)
    prefix = [rng.integers(0, 2, int(n)).astype(np.uint8) for n in bitpos]
    words = pack_bits([prefix, *streams])
    size_bits = bitpos + total
    if truncated:
        cut = np.arange(B) % 4 == 1
        size_bits = np.where(cut, bitpos + total // 2, size_bits)
    i32 = np.int32
    ones = np.ones(B, i32)
    args = (words, bitpos.astype(i32), act, ones * pb, ones * cb, ns, size_bits.astype(i32),
            ones * MB, act2, ones * pb2)
    want = dict(res=res, bits1=bits1, total=total, act=act, act2=act2, ns=ns, bitpos=bitpos)
    return args, dict(kb=kb, F=F, passes=passes), want


def torch_args(args):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)


@pytest.mark.parametrize("name", sorted(CASES))
def test_dense_entropy_matches_pallas_interpret(name):
    args, kw, want = build_case(name)
    passes = kw["passes"]
    words, lane = args[0], args[1:]
    j_args = (jnp.asarray(words.T), *(jnp.asarray(x) for x in lane))
    j_rows, j_bp, j_err = dense_entropy_pallas(*j_args, LB=128, interpret=True, **kw)
    # The port takes what the JAX entry takes, carried over by interop.
    p_args = interop.dense_entropy_inputs_from_jax(*(np.asarray(x) for x in j_args))
    for a, b in zip(p_args, torch_args(args)):
        assert torch.equal(a, b)
    rows, bp, err = walk_kernel.dense_entropy(*p_args, **kw)
    assert rows.shape == (passes, walk_kernel.f_pad(F), B) and rows.dtype == torch.int32

    assert np.array_equal(err.numpy(), np.asarray(j_err))
    assert np.array_equal(bp.numpy(), np.asarray(j_bp))
    j_rows = interop.dense_entropy_rows_from_jax(j_rows, F, passes)
    bad = torch.nonzero(rows[:, :F] != j_rows[:, :F])
    assert bad.numel() == 0, f"rows differ at {bad[:5].tolist()}"
    assert not rows[:, F:].any()

    # Clean lanes give back what was encoded.
    e = err.numpy()
    ns, act, act2 = want["ns"], want["act"], want["act2"]
    truncated = CASES[name][-1]
    if truncated:
        assert (e == walk_kernel.ERR_OVERRUN).sum() >= 10 and set(e.tolist()) <= {0, 1}
    else:
        assert not e.any()
    t = np.arange(F)[None, :] < ns[:, None]
    clean = (e == 0) & (act == 1)
    for p, live in enumerate((clean, clean & (act2 == 1))[:passes]):
        got = rows[p, :F].numpy().T
        assert np.array_equal(got[live], np.where(t, want["res"][p], 0)[live]), f"pass {p}"
    assert not rows[0, :, act == 0].any() and not rows[:, :, ns == 0].any()
    if passes == 2:
        assert not rows[1, :, act2 == 0].any()
    end = want["bitpos"] + want["bits1"] * (ns > 0)
    if passes == 2:
        end = end + (want["total"] - want["bits1"]) * (act2 == 1)
    assert np.array_equal(bp.numpy()[clean], end[clean])
    assert np.array_equal(bp.numpy()[act == 0], want["bitpos"][act == 0])


def test_dense_entropy_rejects_bad_passes():
    args, kw, _ = build_case("port-p1-kb14-cb17")
    with pytest.raises(ValueError):
        walk_kernel.dense_entropy(*torch_args(args), kb=14, F=F, passes=3)
