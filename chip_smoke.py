"""GPU smoke run of the PyTorch/CUDA port (saprobe_alac_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
  1. card identity (nvidia-smi name and power limit, torch and CUDA versions);
  2. build of the CUDA kernels (csrc/, nvcc) and of the C++ host core
     (native/, g++);
  3. each kernel against its plain PyTorch version on the card, B=256
     packets, F=4096, 16-bit stereo, tolerance 0 (integer code): music, a
     partial final packet, near-white noise (escape elements), order-12 LPC
     (the 32-tap variant), order 31 with mode 1, and two corrupted packets;
  4. the decode path at full size: B=2048 packets of F=4096 44.1 kHz 16-bit
     stereo music (about 190 s) through BatchDecoder(cfg, "cuda"), bytes
     equal to the source PCM, both kernels' launch counts above zero, no
     packet on the host fallback; then decode_packets timed by the host
     clock (median of warm runs, x realtime);
  5. each kernel against its plain version at the shapes phase 4 gave it
     (the element kernel on the B=2048 batch, the LPC at 9 taps on its 4096
     lanes), tolerance 0; kernel times by CUDA events (median of warm runs),
     each plain version's once.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Neither JAX nor the JAX package
saprobe_alac_tpu is importable here: both are blocked before any import.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

sys.modules["jax"] = None  # the port must not need JAX ...
sys.modules["saprobe_alac_tpu"] = None  # ... nor the JAX package

import numpy as np
import torch

SEED = 20261016
F = 4096
RUNS = 5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def music_pcm(n, channels, seed, tonality=0.98):
    """Music-like 16-bit PCM: correlated tones plus low-level noise
    (tonality near 0 is near-white noise)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    sig = np.zeros((n, channels))
    for c in range(channels):
        tone = (
            0.35 * np.sin(2 * np.pi * t / (97.3 + 11 * c))
            + 0.2 * np.sin(2 * np.pi * t / (23.7 + 3 * c))
            + 0.1 * np.sin(2 * np.pi * t / (389.0 + 29 * c))
        )
        sig[:, c] = tonality * tone * 0.8 + (1 - tonality) * rng.standard_normal(n) * 0.5
    return np.clip(sig * 32767, -32768, 32767).astype(np.int64)


def timed(fn):
    """(fn(), ms) of one run, by CUDA events."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def cuda_times(fn, runs=RUNS):
    """Per-run ms of fn() by CUDA events, after one warm run."""
    fn()
    return [timed(fn)[1] for _ in range(runs)]


def summary(ms):
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}


def amax(x) -> int:
    return int(x.max()) if x.numel() else 0


def element_diff(got, want, M_NS):
    """Max abs difference of the element kernel against its plain version:
    err on every lane; rows (t < ns), bitpos and meta on lanes with err 0."""
    rows_k, bp_k, err_k, meta_k = got
    rows_r, bp_r, err_r, meta_r = want
    if not torch.equal(err_k, err_r):
        raise AssertionError(f"element err differs at {torch.nonzero(err_k != err_r)[:5].tolist()}")
    ok = err_k == 0
    t = torch.arange(rows_k.shape[1], device=rows_k.device)[None, :, None]
    valid = ((t < meta_r[M_NS][None, None, :]) & ok).expand_as(rows_k)
    return max(
        amax((rows_k - rows_r).abs()[valid]),
        amax((bp_k - bp_r).abs()[ok]),
        amax((meta_k - meta_r).abs()[:, ok]),
    )


def lpc_diff(a, b, ns):
    """Max abs difference of LPC outputs over rows t < ns of each lane."""
    valid = torch.arange(a.shape[0], device=a.device)[:, None] < ns[None, :]
    return amax((a - b).abs()[valid])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import saprobe_alac_tpu_torch as port
    from saprobe_alac_tpu_torch import _build, native
    from saprobe_alac_tpu_torch.ops import lpc_kernel, walk_kernel
    from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder
    from saprobe_alac_tpu_torch.ops.lpc import lpc_lanes
    from saprobe_alac_tpu_torch.ops.walk import walk_batch

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda}")
    tag = f"[{card}]"

    t0 = time.perf_counter()
    _build.load()
    t_nvcc = time.perf_counter() - t0
    native.load()
    t_gxx = time.perf_counter() - t0 - t_nvcc
    regs = [ln.strip() for ln in _build.build_log().splitlines() if "registers" in ln or "spill" in ln]
    print(f"phase 2 build: kernels {t_nvcc:.3f} s, host core {t_gxx:.3f} s; ptxas: {' | '.join(regs)}")

    cfg = port.PacketConfig(
        frame_length=F, bit_depth=16, num_channels=2, pb=40, mb=10, kb=14,
        max_run=255, max_frame_bytes=0, avg_bit_rate=0, sample_rate=44100,
    )
    C = 2
    i32 = torch.int32
    stager = TorchBatchDecoder(cfg, dev)
    e_kw = dict(kb=cfg.kb, F=F, depth=16, pb_cfg=cfg.pb, mb_cfg=cfg.mb, passes=2)

    def element_args(words, sizes):
        B = words.shape[0]
        return (
            words, torch.zeros(B, dtype=i32, device=dev), (sizes > 0).to(i32), sizes,
            torch.full((B,), F, dtype=i32, device=dev), torch.ones(B, dtype=i32, device=dev),
        )

    def lanes(words, sizes):
        """The LPC kernel's inputs as the main path builds them."""
        w = walk_batch(words, sizes, F=F, C=C, depth=16, pb=cfg.pb, mb=cfg.mb, kb=cfg.kb)
        L = words.shape[0] * C
        lane = (
            w.order.T.reshape(L), w.mode.T.reshape(L), w.den.T.reshape(L),
            w.cb.T.reshape(L), w.ns.repeat(C), w.coefs.transpose(0, 1).reshape(L, 32),
        )
        return w, (w.res, *lpc_lanes(*lane))

    # ---- phase 3: kernels against their plain versions (B=256) ----
    pk = []
    for i, (kw, ton, n) in enumerate([
        ({}, 0.98, 60 * F + 1234),  # ends in a partial packet
        ({}, 0.0, 60 * F),  # near-white noise: escapes
        ({"order": 12}, 0.98, 60 * F),
        ({"order": 31, "mode": 1}, 0.98, 76 * F),
    ]):
        pk += native.encode_packets(cfg, music_pcm(n, C, SEED + i, ton), **kw)
    pk = pk[:254]
    rng = np.random.default_rng(SEED)
    bad0 = pk[3][: len(pk[3]) // 3]  # truncated
    bad1 = bytearray(pk[4])
    for i in range(1, 40, 3):  # bit flips; byte 1 holds unused header bits
        bad1[i] ^= 1 << int(rng.integers(0, 8))
    pk += [bad0, bytes(bad1)]
    assert len(pk) == 256
    words, sizes = stager._stage(pk)
    B = words.shape[0]
    e_args = element_args(words, sizes)
    got = walk_kernel.dense_element(*e_args, **e_kw)
    e_err = element_diff(got, walk_kernel.dense_element_reference(*e_args, **e_kw), walk_kernel.M_NS)
    n_err = int((got[2] != 0).sum())
    if e_err != 0:
        raise AssertionError(f"element kernel differs from its plain version: {e_err}")
    if n_err < 2:
        raise AssertionError(f"expected the corrupted packets to flag an error, got {n_err}")

    w, lpc_in = lanes(words, sizes)
    if not (w.order == 12).any() or not (w.order == 31).any() or not (w.esc == 1).any():
        raise AssertionError("phase 3 batch lacks order-12, order-31 or escape lanes")
    l_err = 0
    for taps in (9, 32):
        a = lpc_kernel.lpc_fir(*lpc_in, F=F, taps=taps)
        b, plain_ms_32 = timed(lambda: lpc_kernel.lpc_fir_reference(*lpc_in, F=F, taps=taps))
        l_err = max(l_err, lpc_diff(a, b, w.ns.repeat(C)))
    if l_err != 0:
        raise AssertionError(f"LPC kernel differs from its plain version: {l_err}")
    t_l32 = cuda_times(lambda: lpc_kernel.lpc_fir(*lpc_in, F=F, taps=32))
    print(
        f"phase 3 kernels vs plain (B={B}, F={F}, stereo, tolerance 0): element "
        f"max_abs_err={e_err} ({n_err} error lanes equal), lpc taps 9/32 max_abs_err={l_err}"
    )

    # ---- phase 4: the decode path at full size ----
    n_pk = 2048
    total = (n_pk - 1) * F + 7 * F // 16  # partial final packet
    pcm = music_pcm(total, C, SEED + 7)
    t0 = time.perf_counter()
    pkts = native.encode_packets(cfg, pcm)
    enc_s = time.perf_counter() - t0
    assert len(pkts) == n_pk
    dec = port.BatchDecoder(cfg, "cuda")
    port.reset_launch_counts()
    out = dec.decode_packets(pkts)
    launches = port.launch_counts()
    src = pcm.astype("<i2").reshape(-1)
    for i, o in enumerate(out):
        if o != src[i * F * C : min((i + 1) * F, total) * C].tobytes():
            raise AssertionError(f"packet {i}: bytes differ from the source PCM")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if dec.impl.last_fallbacks:
        raise AssertionError(f"{dec.impl.last_fallbacks} clean packets fell back to the host")
    audio_s = total / cfg.sample_rate
    print(
        f"phase 4 decode_packets B={n_pk} F={F} 16-bit stereo ({audio_s:.1f} s of audio): "
        f"bytes == source PCM; launches {launches}; host fallbacks "
        f"{dec.impl.last_fallbacks}; encode {enc_s:.2f} s"
    )

    host = []
    for _ in range(RUNS + 1):
        t0 = time.perf_counter()
        dec.decode_packets(pkts)
        host.append(time.perf_counter() - t0)
    host = host[1:]
    med = statistics.median(host)
    print(
        f"phase 4 {tag} decode_packets B={n_pk}: s {summary(host)}; "
        f"x realtime median {audio_s / med:.1f} (min {audio_s / max(host):.1f}, "
        f"max {audio_s / min(host):.1f})"
    )

    # ---- phase 5: kernels vs plain at the main path's shapes, and times ----
    words2, sizes2 = stager._stage(pkts)
    B2 = words2.shape[0]
    e_args2 = element_args(words2, sizes2)
    want, el_plain_ms = timed(lambda: walk_kernel.dense_element_reference(*e_args2, **e_kw))
    e_err = max(e_err, element_diff(walk_kernel.dense_element(*e_args2, **e_kw), want, walk_kernel.M_NS))
    w2, lpc_in2 = lanes(words2, sizes2)
    want, lpc_plain_ms = timed(lambda: lpc_kernel.lpc_fir_reference(*lpc_in2, F=F, taps=9))
    l_err = max(l_err, lpc_diff(lpc_kernel.lpc_fir(*lpc_in2, F=F, taps=9), want, w2.ns.repeat(C)))
    if e_err != 0 or l_err != 0:
        raise AssertionError(f"kernels differ from their plain versions at B={B2}: {e_err}, {l_err}")
    t_el = cuda_times(lambda: walk_kernel.dense_element(*e_args2, **e_kw))
    t_lpc = cuda_times(lambda: lpc_kernel.lpc_fir(*lpc_in2, F=F, taps=9))
    print(
        f"phase 5 {tag} kernels vs plain at B={B2} (L={2 * B2}), tolerance 0: max_abs_err "
        f"element {e_err}, lpc {l_err}; element ms {summary(t_el)} | plain {el_plain_ms:.1f}; "
        f"lpc taps 9 ms {summary(t_lpc)} | plain {lpc_plain_ms:.1f}; lpc taps 32 at L={2 * B} "
        f"ms {summary(t_l32)} | plain {plain_ms_32:.1f}"
    )

    kernels = [
        {
            "name": "element", "route": "cuda",
            "source": "saprobe_alac_tpu_torch/csrc/element_kernel.cu",
            "replaces": "saprobe_alac_tpu/ops/walk_kernel.py:747",
            "launches": launches["element"], "max_abs_err": e_err,
            "ms": statistics.median(t_el), "plain_ms": el_plain_ms,
        },
        {
            "name": "lpc", "route": "cuda",
            "source": "saprobe_alac_tpu_torch/csrc/lpc_kernel.cu",
            "replaces": "saprobe_alac_tpu/ops/lpc_kernel.py:91",
            "launches": launches["lpc"], "max_abs_err": l_err,
            "ms": statistics.median(t_lpc), "plain_ms": lpc_plain_ms,
            "ms_taps32_L512": statistics.median(t_l32), "plain_ms_taps32_L512": plain_ms_32,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
