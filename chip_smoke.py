"""GPU smoke run of the PyTorch/CUDA port (saprobe_alac_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
  1. card identity (nvidia-smi name and power limit, torch and CUDA versions);
  2. build of the CUDA kernels (csrc/, nvcc) and of the C++ host core
     (native/, g++);
  3. the element and LPC kernels against their plain PyTorch versions on
     the card, B=256 packets, F=4096, 16-bit stereo, tolerance 0 (integer
     code): music, a partial final packet, near-white noise (escape
     elements), order-12 LPC (the 32-tap variant), order 31 with mode 1,
     and two corrupted packets;
  4. the decode path at full size: B=2048 packets of F=4096 44.1 kHz 16-bit
     stereo music (about 190 s) through BatchDecoder(cfg, "cuda"), bytes
     equal to the source PCM, both kernels' launch counts above zero, no
     packet on the host fallback; then decode_packets timed by the host
     clock (median of warm runs, x realtime);
  5. each kernel against its plain version at the shapes phase 4 gave it
     (the element kernel on the B=2048 batch, the LPC at 9 taps on its 4096
     lanes), tolerance 0; kernel times by CUDA events (median of warm runs),
     each plain version's once;
  6. all three kernels against their plain versions, B=256 packets of
     F=1024 (a plain element walk costs its op launches per row, and phases
     3, 5 and 8 hold the kernels at F=4096), tolerance 0, on the inputs the
     decode path gives them: 24-bit
     stereo bytesShifted=1, 32-bit stereo bytesShifted=2, 24-bit mono and
     32-bit mono bytesShifted=1, each batch music ending in a partial
     packet, near-white noise (escapes of 24- and 32-bit samples) and a
     truncated packet; the raw reader signed and unsigned;
  7. the hi-res decode path at full size: B=2048 packets of F=4096 96 kHz
     24-bit stereo music with bytesShifted=1 (87.4 s of audio) through
     BatchDecoder(cfg) on the default device, bytes equal to the source as
     3-byte samples, the element, LPC and raw reader launch counts above
     zero, no host fallback; decode_packets timed as in phase 4;
  8. all three kernels against their plain versions at the shapes phase 7
     gave them, tolerance 0; their times by CUDA events beside their bounds
     and the plain versions' times; the raw reader cold (L2 flushed before
     each launch) and warm (20 launches back to back);
  9. 20-bit stereo and 32-bit stereo bytesShifted=2 decodes (B=256), bytes
     equal to the source;
 10. a truncated packet through BatchDecoder(cfg) raises the port's
     DecodeError subclass;
 11. the forward LPC kernel and the encode kernel against their plain
     versions, 256 lanes of F=4096 a regime, tolerance 0, on inputs built
     as the encode path builds them: music at orders 4 and 6 (9 taps, int32
     coefficients; order 6 with mode 1; one call of 512 lanes), 12 and 30
     (32 taps, one call), a partial packet, ns == 0, near-white noise at
     chan bits 17 and 32 (escape suffixes of 32 bits), sparse lanes (long
     zero runs) and an all-zero lane; the encode kernel at kb 14 (both
     widths in one call) and at kb 28;
 12. the encode path at full size: encode_packets_device(cfg, spec, pcms)
     on the default device for the B=2048 packets of phase 4's 44.1 kHz
     16-bit stereo PCM with EncoderSpec(channel=ChannelSpec(order=6,
     fit=True)); the packets through BatchDecoder(cfg) on the card: bytes
     equal to the source, no host fallback; the forward LPC and encode
     launch counts above zero; total packet bytes within 2% of the C++ host
     encoder's; both encoders timed by the host clock (x realtime); one
     call under torch.profiler for the card's busy time and top kernels.  Then
     B=256 packets of 96 kHz 24-bit stereo with bytesShifted=1 the same
     way, and B=256 16-bit packets with pinned coefficients, whose bytes
     equal the C++ host encoder's;
 13. both encode-side kernels against their plain versions on the inputs of
     every launch of one more such call (collected by the path itself: two
     forward LPC and two encode launches of L=2048 lanes), tolerance 0, no
     lane overflowing its row; kernel times by CUDA events (median of warm
     runs) beside their bounds, each plain version's once per launch;
     encode_walk alone (the device part of the call) on the call's own
     arguments, by CUDA events.
The line before the last is the kernels' JSON record (each kernel's
launches on its path, max_abs_err, ms, plain_ms, bound_ms, bound_by,
library_ms); the last line is {"ok": true, "device": {...}}.  Neither JAX
nor the JAX package saprobe_alac_tpu is importable here: both are blocked
before any import.
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
#: The card's peaks (H100 SXM data sheet, at the 700 W limit): memory rate,
#: and the CUDA-core rate (float32 outside the tensor cores), used for the
#: integer operations as well, which keeps the operation bound generous.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def music_pcm(n, channels, seed, tonality=0.98, depth=16):
    """Music-like PCM at ``depth`` bits: correlated tones plus low-level
    noise (tonality near 0 is near-white noise)."""
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
    scale = (1 << (depth - 1)) - 1
    return np.clip(sig * scale, -scale - 1, scale).astype(np.int64)


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


def check_decode(out, pcm, depth):
    """Each packet's bytes equal its slice of the source PCM."""
    src = pcm_bytes(pcm, depth)
    per = len(src) // len(pcm) * F
    for i, o in enumerate(out):
        if o != src[i * per : (i + 1) * per]:
            raise AssertionError(f"{depth}-bit packet {i}: bytes differ from the source PCM")


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / CORE_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def timed(fn):
    """(fn(), ms) of one run, by CUDA events."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def cuda_times(fn, runs=RUNS, reps=1):
    """Per-call ms of fn() by CUDA events, after one warm run: each of
    ``runs`` samples times ``reps`` calls back to back."""
    fn()

    def many():
        for _ in range(reps):
            fn()

    return [timed(many)[1] / reps for _ in range(runs)]


def host_times(fn, runs=RUNS):
    """Per-call seconds of fn() by the host clock, after one warm run."""
    fn()
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


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
    from saprobe_alac_tpu_torch.ops import encode_device, encode_kernel, lpc_kernel, walk_kernel
    from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder
    from saprobe_alac_tpu_torch.ops.epilogue import shift_reads
    from saprobe_alac_tpu_torch.ops.lpc import lpc_lanes
    from saprobe_alac_tpu_torch.ops.raw_reader import raw_read, raw_read_reference
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

    def element_kw(c):
        return dict(kb=c.kb, F=c.frame_length, depth=c.bit_depth, pb_cfg=c.pb, mb_cfg=c.mb,
                    passes=c.num_channels)

    def element_args(words, sizes, channels=C, frame=F):
        """The element kernel's inputs as walk_batch builds them."""
        B = words.shape[0]
        return (
            words, torch.zeros(B, dtype=i32, device=dev), (sizes > 0).to(i32), sizes,
            torch.full((B,), frame, dtype=i32, device=dev),
            torch.full((B,), int(channels > 1), dtype=i32, device=dev),
        )

    def walk(c, words, sizes):
        return walk_batch(words, sizes, F=c.frame_length, C=c.num_channels, depth=c.bit_depth,
                          pb=c.pb, mb=c.mb, kb=c.kb)

    def lanes(w, channels=C):
        """The LPC kernel's inputs as the main path builds them."""
        L = w.ns.numel() * channels
        lane = (
            w.order.T.reshape(L), w.mode.T.reshape(L), w.den.T.reshape(L),
            w.cb.T.reshape(L), w.ns.repeat(channels), w.coefs.transpose(0, 1).reshape(L, 32),
        )
        return (w.res, *lpc_lanes(*lane))

    def check_walk_lpc(c, words, sizes, w):
        """The element kernel and the 9-tap LPC kernel against their plain
        versions on one batch: (element err, LPC err, element plain ms, LPC
        plain ms, error lanes)."""
        ch, Fc = c.num_channels, c.frame_length
        args, kw = element_args(words, sizes, ch, Fc), element_kw(c)
        want, el_ms = timed(lambda: walk_kernel.dense_element_reference(*args, **kw))
        e = element_diff(walk_kernel.dense_element(*args, **kw), want, walk_kernel.M_NS)
        lin = lanes(w, ch)
        want_l, lpc_ms = timed(lambda: lpc_kernel.lpc_fir_reference(*lin, F=Fc, taps=9))
        lp = lpc_diff(lpc_kernel.lpc_fir(*lin, F=Fc, taps=9), want_l, w.ns.repeat(ch))
        if e != 0 or lp != 0:
            raise AssertionError(
                f"{c.bit_depth}-bit C={ch} B={words.shape[0]}: element {e}, LPC {lp} "
                "against their plain versions"
            )
        return e, lp, el_ms, lpc_ms, int((want[2] != 0).sum())

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
    w = walk(cfg, words, sizes)
    if not (w.order == 12).any() or not (w.order == 31).any() or not (w.esc == 1).any():
        raise AssertionError("phase 3 batch lacks order-12, order-31 or escape lanes")
    e_err, l_err, el_plain_256, _, n_err = check_walk_lpc(cfg, words, sizes, w)
    if n_err < 2:
        raise AssertionError(f"expected the corrupted packets to flag an error, got {n_err}")
    lpc_in = lanes(w)
    a = lpc_kernel.lpc_fir(*lpc_in, F=F, taps=32)
    b, plain_ms_32 = timed(lambda: lpc_kernel.lpc_fir_reference(*lpc_in, F=F, taps=32))
    l_err = max(l_err, lpc_diff(a, b, w.ns.repeat(C)))
    if l_err != 0:
        raise AssertionError(f"LPC kernel (32 taps) differs from its plain version: {l_err}")
    t_l32 = cuda_times(lambda: lpc_kernel.lpc_fir(*lpc_in, F=F, taps=32))
    print(
        f"phase 3 kernels vs plain (B={B}, F={F}, stereo, tolerance 0): element "
        f"max_abs_err={e_err} ({n_err} error lanes equal; plain {el_plain_256:.1f} ms), "
        f"lpc taps 9/32 max_abs_err={l_err}"
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
    check_decode(out, pcm, 16)
    if min(launches["element"], launches["lpc"]) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if dec.impl.last_fallbacks:
        raise AssertionError(f"{dec.impl.last_fallbacks} clean packets fell back to the host")
    audio_s = total / cfg.sample_rate
    print(
        f"phase 4 decode_packets B={n_pk} F={F} 16-bit stereo ({audio_s:.1f} s of audio): "
        f"bytes == source PCM; launches {launches}; host fallbacks "
        f"{dec.impl.last_fallbacks}; encode {enc_s:.2f} s"
    )

    host = host_times(lambda: dec.decode_packets(pkts))
    med = statistics.median(host)
    print(
        f"phase 4 {tag} decode_packets B={n_pk}: s {summary(host)}; "
        f"x realtime median {audio_s / med:.1f} (min {audio_s / max(host):.1f}, "
        f"max {audio_s / min(host):.1f})"
    )

    # ---- phase 5: kernels vs plain at the main path's shapes, and times ----
    words2, sizes2 = stager._stage(pkts)
    B2 = words2.shape[0]
    w2 = walk(cfg, words2, sizes2)
    e5, l5, el_plain_ms, lpc_plain_ms, _ = check_walk_lpc(cfg, words2, sizes2, w2)
    e_err, l_err = max(e_err, e5), max(l_err, l5)
    e_args2, lpc_in2 = element_args(words2, sizes2), lanes(w2)
    e_kw = element_kw(cfg)
    t_el = cuda_times(lambda: walk_kernel.dense_element(*e_args2, **e_kw))
    t_lpc = cuda_times(lambda: lpc_kernel.lpc_fir(*lpc_in2, F=F, taps=9))
    print(
        f"phase 5 {tag} kernels vs plain at B={B2} (L={2 * B2}), tolerance 0: max_abs_err "
        f"element {e_err}, lpc {l_err}; element ms {summary(t_el)} | plain {el_plain_ms:.1f}; "
        f"lpc taps 9 ms {summary(t_lpc)} | plain {lpc_plain_ms:.1f}; lpc taps 32 at L={2 * B} "
        f"ms {summary(t_l32)} | plain {plain_ms_32:.1f}"
    )

    def walk_bounds(w, sizes, lpc_in):
        """Bounds of the element and 9-tap LPC kernels' work on one batch:
        bytes each input read once (the packets' own bits, not the padding)
        and each output written once; operations a lower count of what
        these inputs need."""
        Bw = sizes.numel()
        ns = w.ns.double()
        nch = 1 + (w.role[:, 0] == 1).double()
        el = bound(
            float(sizes.double().sum()) / 8 + 4 * Bw * (5 + 2 + walk_kernel.META_ROWS)
            + 4 * 2 * walk_kernel.f_pad(F) * Bw,
            8 * float((ns * nch).sum()),  # a Rice decode: window, clz, shifts, map
        )
        res, fir, order = lpc_in[0], lpc_in[1], lpc_in[2]
        L = order.numel()
        lp = bound(
            4 * (res.numel() + L * (7 + 9) + walk_kernel.f_pad(F) * L),
            2 * float((lpc_in[5].double() * order.double() * (fir == 1)).sum()),  # MACs
        )
        return el, lp

    el_bound, lpc_bound = walk_bounds(w2, sizes2, lpc_in2)

    # ---- phase 6: every kernel against its plain version on hi-res batches (B=256) ----
    def hires_config(depth, channels, rate=96000, frame=F):
        return port.PacketConfig(
            frame_length=frame, bit_depth=depth, num_channels=channels, pb=40, mb=10, kb=14,
            max_run=255, max_frame_bytes=0, avg_bit_rate=0, sample_rate=rate,
        )

    def hires_inputs(c, packets):
        """The words, the walk and the raw reader's lane inputs as the decode
        path builds them (walk, then epilogue.shift_reads)."""
        words, sizes = TorchBatchDecoder(c, dev)._stage(packets)
        w = walk(c, words, sizes)
        return words, sizes, w, shift_reads(w.shift_base, w.bs, w.role, w.ns)

    # Packets of F6 samples: a plain element walk costs its op launches per
    # row whatever B is, and phases 3, 5 and 8 hold the kernels at F=4096.
    F6 = 1024
    r_err, r_lines = 0, []
    for i, (depth, ch, bsf, quiet) in enumerate([
        (24, 2, 1, 0), (32, 2, 2, 0), (24, 1, 1, 0),
        (32, 1, 1, 8),  # 24-bit music: at full scale every packet is an escape
    ]):
        hc = hires_config(depth, ch, frame=F6)
        music = music_pcm(214 * F6 + F6 // 3, ch, SEED + 20 + i, depth=depth) >> quiet
        noise = music_pcm(40 * F6, ch, SEED + 24 + i, tonality=0.0, depth=depth)
        pk = native.encode_packets(hc, music, bytes_shifted=bsf)  # ends in a partial packet
        pk += native.encode_packets(hc, noise, bytes_shifted=bsf)  # escapes
        pk.append(pk[3][: len(pk[3]) // 3])  # truncated
        assert len(pk) == 256
        words, sizes, w, args = hires_inputs(hc, pk)
        shifted = int((w.bs[:, 0] == bsf).sum())
        if shifted < 200 or not (w.esc == 1).any():
            raise AssertionError(f"{depth}-bit C={ch}: {shifted} shifted lanes, or no escapes")
        for signed in (False, True):
            a = raw_read(words, *args, F=F6, signed=signed)
            b = raw_read_reference(words, *args, F=F6, signed=signed)
            r_err = max(r_err, amax((a - b).abs()))
        if r_err != 0:
            raise AssertionError(f"{depth}-bit C={ch}: raw reader differs from its plain version")
        e6, l6, el_ms, _, n_bad = check_walk_lpc(hc, words, sizes, w)
        e_err, l_err = max(e_err, e6), max(l_err, l6)
        if n_bad < 1:
            raise AssertionError(f"{depth}-bit C={ch}: the truncated packet flagged no error")
        r_lines.append(
            f"{depth}-bit C={ch} bs={bsf}: {shifted} shifted lanes, "
            f"{int((w.esc == 1).sum())} escapes, {n_bad} error lanes equal "
            f"(plain element {el_ms:.0f} ms)"
        )
    print(
        f"phase 6 element, lpc (9 taps) and raw reader (signed and unsigned) vs plain "
        f"(B=256, F={F6}, tolerance 0): max_abs_err element {e_err}, lpc {l_err}, raw "
        f"reader {r_err}; {'; '.join(r_lines)}"
    )

    # ---- phase 7: the hi-res decode path at full size ----
    hcfg = hires_config(24, 2)
    hpcm = music_pcm(total, C, SEED + 30, depth=24)
    t0 = time.perf_counter()
    hpkts = native.encode_packets(hcfg, hpcm, bytes_shifted=1)
    enc_s = time.perf_counter() - t0
    assert len(hpkts) == n_pk
    hdec = port.BatchDecoder(hcfg)  # the default device: the card
    if hdec.impl.device.type != "cuda":
        raise AssertionError(f"BatchDecoder(cfg) runs on {hdec.impl.device}, not the card")
    port.reset_launch_counts()
    hout = hdec.decode_packets(hpkts)
    h_launches = port.launch_counts()
    check_decode(hout, hpcm, 24)
    if min(h_launches[k] for k in ("element", "lpc", "raw_read")) < 1:
        raise AssertionError(f"a kernel of the hi-res path never launched: {h_launches}")
    if hdec.impl.last_fallbacks:
        raise AssertionError(f"{hdec.impl.last_fallbacks} clean hi-res packets fell back")
    h_audio_s = total / hcfg.sample_rate
    print(
        f"phase 7 decode_packets B={n_pk} F={F} 96 kHz 24-bit stereo bytesShifted=1 "
        f"({h_audio_s:.1f} s of audio): bytes == source PCM (3-byte samples); launches "
        f"{h_launches}; host fallbacks {hdec.impl.last_fallbacks}; encode {enc_s:.2f} s"
    )
    h_host = host_times(lambda: hdec.decode_packets(hpkts))
    h_med = statistics.median(h_host)
    print(
        f"phase 7 {tag} decode_packets hi-res B={n_pk}: s {summary(h_host)}; "
        f"x realtime median {h_audio_s / h_med:.1f} (min {h_audio_s / max(h_host):.1f}, "
        f"max {h_audio_s / min(h_host):.1f})"
    )

    # ---- phase 8: every kernel vs plain at the hi-res path's shapes, and times ----
    hwords, hsizes, hw, hargs = hires_inputs(hcfg, hpkts)
    e8, l8, h_el_plain_ms, h_lpc_plain_ms, _ = check_walk_lpc(hcfg, hwords, hsizes, hw)
    e_err, l_err = max(e_err, e8), max(l_err, l8)
    want = raw_read_reference(hwords, *hargs, F=F)
    r_err = max(r_err, amax((raw_read(hwords, *hargs, F=F) - want).abs()))
    if r_err != 0:
        raise AssertionError(f"raw reader differs from its plain version at B={n_pk}: {r_err}")
    h_e_args, h_lpc_in = element_args(hwords, hsizes), lanes(hw)
    h_e_kw = element_kw(hcfg)
    t_hel = cuda_times(lambda: walk_kernel.dense_element(*h_e_args, **h_e_kw))
    t_hlpc = cuda_times(lambda: lpc_kernel.lpc_fir(*h_lpc_in, F=F, taps=9))
    h_el_bound, h_lpc_bound = walk_bounds(hw, hsizes, h_lpc_in)
    # The raw reader cold (L2 flushed by a 1 GiB write before each launch,
    # as after the walk and the LPC on the real path) and warm (20 launches
    # back to back over the same ~50 MB, about the size of L2).
    flush = torch.empty(1 << 28, dtype=i32, device=dev)

    def cold_read():
        flush.zero_()
        return timed(lambda: raw_read(hwords, *hargs, F=F))[1]

    cold_read()
    t_rr = [cold_read() for _ in range(RUNS)]
    del flush
    t_rr_warm = cuda_times(lambda: raw_read(hwords, *hargs, F=F), reps=20)
    t_rr_plain = cuda_times(lambda: raw_read_reference(hwords, *hargs, F=F))
    base, step, _, act, n = hargs
    fields = torch.where(act != 0, n, 0).double()
    rr_bound = bound(
        float((fields * step.double()).sum()) / 8 + 4 * n_pk * 5 + 4 * want.numel(),
        4 * float(fields.sum()),  # two shifts, an or, a shift per field
    )
    print(
        f"phase 8 {tag} kernels vs plain at B={n_pk} F={F} 24-bit stereo bytesShifted=1, "
        f"tolerance 0: max_abs_err element {e_err}, lpc {l_err}, raw reader {r_err}; "
        f"element ms {summary(t_hel)} | plain {h_el_plain_ms:.1f} | bound "
        f"{h_el_bound[0]:.4f} by {h_el_bound[1]}; lpc taps 9 ms {summary(t_hlpc)} | plain "
        f"{h_lpc_plain_ms:.1f} | bound {h_lpc_bound[0]:.4f} by {h_lpc_bound[1]}; raw reader "
        f"(the pair as one {int(step[0])}-bit field) ms cold {summary(t_rr)} | warm "
        f"{summary(t_rr_warm)} (20 launches per sample) | plain {summary(t_rr_plain)} | "
        f"bound {rr_bound[0]:.4f} by {rr_bound[1]}"
    )

    # ---- phase 9: 20-bit and 32-bit decodes ----
    d_lines = []
    for depth, bsf in ((20, 0), (32, 2)):
        dc = hires_config(depth, 2, rate=48000)
        dpcm = music_pcm(255 * F + 777, C, SEED + 40 + depth, depth=depth)
        ddec = port.BatchDecoder(dc)
        dout = ddec.decode_packets(native.encode_packets(dc, dpcm, bytes_shifted=bsf))
        check_decode(dout, dpcm, depth)
        if ddec.impl.last_fallbacks:
            raise AssertionError(f"{ddec.impl.last_fallbacks} clean {depth}-bit packets fell back")
        d_lines.append(f"{depth}-bit stereo bytesShifted={bsf} B={len(dout)}: bytes == source")
    print(f"phase 9 {'; '.join(d_lines)}; host fallbacks 0")

    # ---- phase 10: the typed error on the card ----
    try:
        hdec.decode_packets([hpkts[0], hpkts[1][: len(hpkts[1]) // 3]])
    except port.DecodeError as exc:
        err_name = type(exc).__name__
    else:
        raise AssertionError("a truncated packet decoded without an error")
    print(f"phase 10 truncated packet through BatchDecoder(cfg): raised the port's {err_name}")

    # ---- phase 11: the encode-side kernels against their plain versions (B=256) ----
    i64 = torch.int64

    def enc_lanes(cb, seed):
        """(x (256, F) int32 on the card, ns (256,)): music, 20 lanes of
        full-scale noise at ``cb`` bits, 10 sparse lanes (long zero runs),
        an all-zero lane, an empty and a partial packet."""
        g = np.random.default_rng(seed)
        x = music_pcm(256 * F, 1, seed, depth=min(cb - 1, 24))[:, 0].reshape(256, F)
        x[200:220] = g.integers(-(1 << (cb - 1)), 1 << (cb - 1), size=(20, F))
        x[220:230] = np.where(g.random((10, F)) < 0.002, g.integers(-40, 40, size=(10, F)), 0)
        x[230] = 0
        ns = np.full(256, F, np.int32)
        ns[231], ns[232] = 0, F // 3 + 1
        return torch.from_numpy(x.astype(np.int32)).to(dev), torch.from_numpy(ns).to(dev)

    def lpc_forward_check(args, kw):
        """The forward LPC kernel against its plain version on one set of
        inputs, every row: (residuals (F, L), plain ms, max abs difference)."""
        got = lpc_kernel.lpc_fir(*args, **kw)
        want, ms = timed(lambda: lpc_kernel.lpc_fir_reference(*args, **kw))
        err = amax((got.to(i64) - want.to(i64)).abs())
        if err != 0:
            raise AssertionError(
                f"forward LPC (orders {sorted(set(args[2].tolist()))}, taps {kw['taps']}, "
                f"L={args[2].numel()}) differs from its plain version: max {err}"
            )
        return got[:F], ms, err

    def encode_check(args, kw):
        """The encode kernel against its plain version on one set of inputs,
        words (zero tails included), bits and ovf: (bits, ovf, plain ms, max
        abs difference over the three outputs)."""
        got = encode_kernel.dense_encode(*args, **kw)
        want, ms = timed(lambda: encode_kernel.dense_encode_reference(*args, **kw))
        errs = [amax((a.to(i64) - b.to(i64)).abs()) for a, b in zip(got, want)]
        for name, a, b, err in zip(("words", "bits", "ovf"), got, want, errs):
            if err != 0:
                raise AssertionError(
                    f"encode kernel (kb {kw['kb']}, B={a.shape[0]}): {name} differs from the "
                    f"plain version by up to {err} at {torch.nonzero(a != b)[:3].tolist()}"
                )
        return got[1], got[2], ms, max(errs)

    def side_by_side(a, b, lane_axes):
        """Two sets of a kernel's inputs as one, joined along each tensor's
        lane axis (every lane carries its own order, mode and widths)."""
        return tuple(torch.cat([p, q], dim=ax) for p, q, ax in zip(a, b, lane_axes))

    def body_words(kb, cb):
        return (F * (9 + max(kb, cb) + 26) + 256) // 32 + 4

    # Two orders share each forward-LPC call and two widths the kb 14 encode
    # call, so each plain version (seconds per run) runs once per tap count
    # and per kb.
    shared0 = torch.zeros((256, 32), dtype=i32, device=dev)
    fwd_err, enc_err = 0, 0
    f_lines, res_by_cb = [], {}
    for taps, regimes in ((9, ((4, 0, 17), (6, 1, 17))), (32, ((12, 0, 17), (30, 0, 32)))):
        sets = []
        for order, mode, cb in regimes:
            x, ns11 = enc_lanes(cb, SEED + 50 + order)
            coefs = encode_device.fit_coefs(x, ns11.to(i64), order, 9, shared0)
            args, got_taps = encode_device._lpc_forward_args(x, order, 9, cb, ns11, coefs, F, mode)
            if got_taps != taps:
                raise AssertionError(f"order {order} runs at {got_taps} taps, not {taps}")
            sets.append((args, cb, ns11))
        args = side_by_side(sets[0][0], sets[1][0], (2, 0, 0, 0, 0, 0, 0, 0, 0))
        res, ms, err = lpc_forward_check(args, dict(F=F, taps=taps, forward=True))
        fwd_err = max(fwd_err, err)
        for i, (_, cb, ns11) in enumerate(sets):
            res_by_cb.setdefault(cb, (res[:, 256 * i : 256 * (i + 1)].T.contiguous(), ns11))
        f_lines.append(
            f"taps {taps}: " + " and ".join(f"order {o} mode {m} cb {c}" for o, m, c in regimes)
            + f" (L=512, plain {ms:.0f} ms)"
        )
    pb_local = torch.full((256,), cfg.pb, dtype=i32, device=dev)

    def entropy_inputs(cb):
        res, ns11 = res_by_cb[cb]
        return encode_device._entropy_args(res, ns11, pb_local, cb, cfg.mb)

    e_lines = []
    for kb, cbs in ((14, (17, 32)), (28, (32,))):
        args = entropy_inputs(cbs[0])
        if len(cbs) == 2:
            args = side_by_side(args, entropy_inputs(cbs[1]), (1, 1, 0, 0, 0, 0, 0))
        bits11, ovf11, ms, err = encode_check(args, dict(kb=kb, F=F, W_out=body_words(kb, max(cbs))))
        enc_err = max(enc_err, err)
        for i, cb in enumerate(cbs):
            lane0 = 256 * i
            zero_runs = int((args[1][:, lane0 + 220 : lane0 + 231] > F // 16).sum())
            noise_bits = int(bits11[lane0 + 200 : lane0 + 220].min())
            if int(bits11[lane0 + 231]) != 0 or int(ovf11.sum()) != 0 or zero_runs == 0:
                raise AssertionError(f"phase 11 kb {kb} cb {cb}: empty lane, ovf or zero runs wrong")
            # At kb 14 a 32-bit noise value always escapes: a 9-one prefix and 32 raw bits.
            if (kb, cb) == (14, 32) and noise_bits < F * 41 * 9 // 10:
                raise AssertionError("phase 11 kb 14 cb 32: the noise lanes did not escape")
            e_lines.append(
                f"kb {kb} cb {cb}: {int(bits11[lane0 : lane0 + 256].sum()) // 8} bytes, noise "
                f"lanes {noise_bits}+ bits"
            )
        e_lines[-1] += f" (B={256 * len(cbs)}, plain {ms:.0f} ms)"
    print(
        f"phase 11 forward lpc and encode kernels vs plain (256 lanes a regime, F={F}, "
        f"tolerance 0): max_abs_err forward lpc {fwd_err}, encode {enc_err}; forward lpc "
        f"{'; '.join(f_lines)}; encode {'; '.join(e_lines)}"
    )

    # ---- phase 12: the encode path at full size ----
    def encode_and_check(c, spec, pcm_all, label):
        """encode_packets_device on the default device, the packets decoded
        on the card against the source, sizes against the C++ host encoder:
        (packets, launches, host packets, device s, host s)."""
        depth = c.bit_depth
        chunks = [pcm_all[i : i + F] for i in range(0, len(pcm_all), F)]
        port.reset_launch_counts()
        t0 = time.perf_counter()
        got = port.encode_packets_device(c, spec, chunks)
        dev_s = time.perf_counter() - t0
        counts = port.launch_counts()
        if min(counts["lpc_forward"], counts["encode"]) < 1:
            raise AssertionError(f"{label}: an encode kernel never launched: {counts}")
        d = port.BatchDecoder(c)
        check_decode(d.decode_packets(got), pcm_all, depth)
        if d.impl.last_fallbacks:
            raise AssertionError(f"{label}: {d.impl.last_fallbacks} encoded packets fell back")
        t0 = time.perf_counter()
        host_pk = native.encode_with_spec(c, spec, chunks)
        host_s = time.perf_counter() - t0
        n_dev, n_host = sum(map(len, got)), sum(map(len, host_pk))
        if abs(n_dev - n_host) > 0.02 * n_host:
            raise AssertionError(f"{label}: {n_dev} bytes against the host encoder's {n_host}")
        return got, counts, host_pk, dev_s, host_s

    fit_spec = port.EncoderSpec(channel=port.ChannelSpec(order=6, fit=True))
    chunks16 = [pcm[i : i + F] for i in range(0, len(pcm), F)]
    epk, e_launches, host_pk, first_s, host_enc_s = encode_and_check(cfg, fit_spec, pcm, "16-bit")
    enc_host = host_times(lambda: port.encode_packets_device(cfg, fit_spec, chunks16), runs=3)
    enc_med = statistics.median(enc_host)
    n_dev, n_host = sum(map(len, epk)), sum(map(len, host_pk))
    print(
        f"phase 12 encode_packets_device B={n_pk} F={F} 16-bit stereo order 6 fit "
        f"({audio_s:.1f} s of audio): decoded on the card == source PCM; launches "
        f"{e_launches}; host fallbacks 0; {n_dev} bytes against the C++ host encoder's "
        f"{n_host} ({100 * (n_dev - n_host) / n_host:+.3f}%)"
    )
    print(
        f"phase 12 {tag} encode_packets_device B={n_pk}: first call {first_s:.3f} s; warm s "
        f"{summary(enc_host)}; x realtime median {audio_s / enc_med:.1f}; C++ host encoder "
        f"(one thread) {host_enc_s:.3f} s, x realtime {audio_s / host_enc_s:.1f}"
    )
    # One profiled call: how much of it the card is busy, and with what.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        port.encode_packets_device(cfg, fit_spec, chunks16)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    # Device-side events only (kernels and copies): an operator's row repeats
    # its kernels' time, and the profiler's own buffer request is not work.
    dev_us = sorted(
        ((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
         and not e.key.startswith("Activity Buffer")),
        reverse=True,
    )
    busy_ms = sum(us for us, _, _ in dev_us) / 1e3
    top = "; ".join(f"{key[:48]} {us / 1e3:.2f} ms x{n}" for us, n, key in dev_us[:6])
    print(
        f"phase 12 {tag} one profiled encode_packets_device call ({prof_s * 1e3:.0f} ms under "
        f"the profiler): device busy "
        + (f"{busy_ms:.1f} ms in {sum(n for _, n, _ in dev_us)} kernels and copies; top: {top}"
           if dev_us else "not measured (the profiler saw no device time)")
    )
    hi_pcm = hpcm[: 255 * F + 999]
    hi_spec = port.EncoderSpec(channel=port.ChannelSpec(order=6, fit=True), bytes_shifted=1)
    hpk, hi_launches, hi_host_pk, _, _ = encode_and_check(hcfg, hi_spec, hi_pcm, "hi-res")
    pin_spec = port.EncoderSpec(channel=port.ChannelSpec(order=6, coefs=[160, 80, 40, 20, 10, 5]))
    ppk, _, pin_host_pk, _, _ = encode_and_check(cfg, pin_spec, pcm[: 255 * F + 999], "pinned")
    if ppk != pin_host_pk:
        bad = [i for i, (a, b) in enumerate(zip(ppk, pin_host_pk)) if a != b]
        raise AssertionError(f"pinned coefficients: packets {bad[:5]} differ from the host's")
    print(
        f"phase 12 B=256 96 kHz 24-bit stereo bytesShifted=1 order 6 fit: decoded == source; "
        f"launches {hi_launches}; {sum(map(len, hpk))} bytes against the host's "
        f"{sum(map(len, hi_host_pk))}; B=256 16-bit pinned coefficients: {len(ppk)} packets "
        f"byte-equal to the C++ host encoder's"
    )

    # ---- phase 13: the encode-side kernels vs plain on phase 12's inputs, and times ----
    # One more call of phase 12's, collecting what it hands encode_walk and
    # each kernel: every launch of the call is held to its plain version.
    encode_device._calls = calls = []
    try:
        port.encode_packets_device(cfg, fit_spec, chunks16)
    finally:
        encode_device._calls = None
    by = {
        name: [(a, kw) for n, a, kw in calls if n == name]
        for name in ("encode_walk", "lpc_forward", "encode")
    }
    n_calls = {name: len(v) for name, v in by.items()}
    if n_calls != {"encode_walk": 1, "lpc_forward": e_launches["lpc_forward"],
                   "encode": e_launches["encode"]}:
        raise AssertionError(f"collected {n_calls} calls against launches {e_launches}")
    t_fwd, fwd_plain, fwd_bounds = [], [], []
    for f_args, f_kw in by["lpc_forward"]:
        _, ms, err = lpc_forward_check(f_args, f_kw)
        fwd_err = max(fwd_err, err)
        fwd_plain.append(ms)
        t_fwd += cuda_times(lambda: lpc_kernel.lpc_fir(*f_args, **f_kw))
        rows, order13, ns_f, coefs13 = f_args[0], f_args[2], f_args[5], f_args[8]
        fwd_bounds.append(bound(
            4 * (2 * rows.numel() + 7 * order13.numel() + coefs13.numel()),  # rows in and out
            2 * float((order13.double() * ns_f.double()).sum()),  # MACs of the prediction
        ))
    t_enc, enc_plain, enc_bounds, body_bytes = [], [], [], 0
    for e_args, e_kw in by["encode"]:
        bits13, ovf13, ms, err = encode_check(e_args, e_kw)
        enc_err = max(enc_err, err)
        if int(ovf13.sum()) != 0:
            raise AssertionError(f"{int(ovf13.sum())} lanes overflowed their row")
        enc_plain.append(ms)
        body_bytes += int(bits13.sum()) // 8
        t_enc += cuda_times(lambda: encode_kernel.dense_encode(*e_args, **e_kw))
        lanes13 = e_args[5].numel()
        enc_bounds.append(bound(
            # rows in, zero-tailed rows out
            4 * (e_args[0].numel() + e_args[1].numel() + 5 * lanes13
                 + lanes13 * e_kw["W_out"] + 2 * lanes13),
            16 * float(e_args[5].sum()),  # a Rice code: clz, divide, shifts, mean update
        ))
    fwd_plain_ms, enc_plain_ms = statistics.median(fwd_plain), statistics.median(enc_plain)
    fwd_bound, enc_bound = max(fwd_bounds), max(enc_bounds)
    f_kw, e_kw = by["lpc_forward"][0][1], by["encode"][0][1]
    print(
        f"phase 13 {tag} encode-side kernels vs plain on every launch of one "
        f"encode_packets_device call (B={n_pk}, F={F}; {n_calls['lpc_forward']} forward lpc, "
        f"{n_calls['encode']} encode), tolerance 0: max_abs_err forward lpc {fwd_err}, encode "
        f"{enc_err}, ovf 0; forward lpc taps {f_kw['taps']} ms {summary(t_fwd)} | plain "
        f"{fwd_plain} | bound {fwd_bound[0]:.4f} by {fwd_bound[1]}; encode ms {summary(t_enc)} "
        f"| plain {enc_plain} | bound {enc_bound[0]:.4f} by {enc_bound[1]}; bodies "
        f"{body_bytes} bytes in rows of {e_kw['W_out']} words"
    )
    # The device part of the call alone (planes already on the card to words
    # and bit counts on the card); the rest of the call is host staging, the
    # upload, the download and the per-packet cut.
    w_args, w_kw = by["encode_walk"][0]
    n_ovf = int(encode_device.encode_walk(*w_args, **w_kw)[2].sum())
    if n_ovf:
        raise AssertionError(f"encode_walk: {n_ovf} lanes overflowed")
    t_walk = cuda_times(lambda: encode_device.encode_walk(*w_args, **w_kw), runs=3)
    print(
        f"phase 13 {tag} encode_walk alone at B={n_pk} (device part of encode_packets_device, "
        f"whose warm median is {enc_med * 1e3:.1f} ms): ovf 0; ms {summary(t_walk)}"
    )

    kernels = [
        {
            "name": "element", "route": "cuda",
            "source": "saprobe_alac_tpu_torch/csrc/element_kernel.cu",
            "replaces": "saprobe_alac_tpu/ops/walk_kernel.py:747",
            "launches": launches["element"], "max_abs_err": e_err,
            "ms": statistics.median(t_el), "plain_ms": el_plain_ms,
            "bound_ms": el_bound[0], "bound_by": el_bound[1], "library_ms": None,
            "ms_hires": statistics.median(t_hel), "plain_ms_hires": h_el_plain_ms,
            "bound_ms_hires": h_el_bound[0],
        },
        {
            "name": "lpc", "route": "cuda",
            "source": "saprobe_alac_tpu_torch/csrc/lpc_kernel.cu",
            "replaces": "saprobe_alac_tpu/ops/lpc_kernel.py:91",
            "launches": launches["lpc"], "max_abs_err": l_err,
            "ms": statistics.median(t_lpc), "plain_ms": lpc_plain_ms,
            "bound_ms": lpc_bound[0], "bound_by": lpc_bound[1], "library_ms": None,
            "ms_taps32_L512": statistics.median(t_l32), "plain_ms_taps32_L512": plain_ms_32,
            "ms_hires": statistics.median(t_hlpc), "plain_ms_hires": h_lpc_plain_ms,
            "bound_ms_hires": h_lpc_bound[0],
        },
        {
            "name": "raw_read", "route": "cuda",
            "source": "saprobe_alac_tpu_torch/csrc/raw_reader_kernel.cu",
            "replaces": "saprobe_alac_tpu/ops/walk_kernel.py:1252",
            "launches": h_launches["raw_read"], "max_abs_err": r_err,
            "ms": statistics.median(t_rr), "plain_ms": statistics.median(t_rr_plain),
            "bound_ms": rr_bound[0], "bound_by": rr_bound[1], "library_ms": None,
            "ms_warm": statistics.median(t_rr_warm),
        },
        {
            "name": "lpc_forward", "route": "cuda",
            "source": "saprobe_alac_tpu_torch/csrc/lpc_kernel.cu",
            "replaces": "saprobe_alac_tpu/ops/lpc_kernel.py:91 (forward=True)",
            "launches": e_launches["lpc_forward"], "max_abs_err": fwd_err,
            "ms": statistics.median(t_fwd), "plain_ms": fwd_plain_ms,
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": None,
        },
        {
            "name": "encode", "route": "cuda",
            "source": "saprobe_alac_tpu_torch/csrc/encode_kernel.cu",
            "replaces": "saprobe_alac_tpu/ops/encode_kernel.py:81",
            "launches": e_launches["encode"], "max_abs_err": enc_err,
            "ms": statistics.median(t_enc), "plain_ms": enc_plain_ms,
            "bound_ms": enc_bound[0], "bound_by": enc_bound[1], "library_ms": None,
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
