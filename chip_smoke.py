"""GPU smoke run of the PyTorch/CUDA port (saprobe_alac_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py
    python3 chip_smoke.py --corpus-only DIR   # phase 23 alone, DIR's package

``--corpus-only DIR`` runs phase 23 alone on the package in DIR (its
saprobe_alac_tpu_torch/ and native/, e.g. an earlier commit unpacked with
``git archive <commit> saprobe_alac_tpu_torch native | tar -x -C DIR``), for
its memory trajectory beside this tree's.

Phases, one line each (any failure raises and exits non-zero):
  1. card identity (nvidia-smi name and power limit, torch and CUDA versions);
  2. build of the CUDA kernels (csrc/, nvcc) and of the C++ host core
     (native/, g++); the three walk kernels', the LPC kernel's four
     instantiations', the encode kernel's, the raw reader's and the
     epilogue kernel's registers, stack and spills as ptxas reports them,
     the instructions of each LPC row loop and of the encode kernel's
     sample loop, and the encode and raw reader kernels' instructions
     (SASS, cuobjdump);
  3. the element and LPC kernels against their plain PyTorch versions on
     the card, B=256 packets of F=512, 16-bit stereo, tolerance 0 (integer
     code): music, a partial final packet, near-white noise (escape
     elements), order-12 LPC (the 32-tap variant), order 31 with mode 1,
     and two corrupted packets;
  4. the decode path at full size: B=2048 packets of F=4096 44.1 kHz 16-bit
     stereo music (about 190 s) through BatchDecoder(cfg, "cuda"), bytes
     equal to the source PCM, one packet walk, one LPC and one epilogue
     launch and no element launch, no packet on the host fallback; then
     decode_packets timed by the host clock (median of warm runs, x
     realtime);
  5. each kernel against its plain version at the shapes phase 4 gave it
     (the packet kernel on the B=2048 batch, the LPC at 9 taps on its 4096
     lanes), tolerance 0; kernel times by CUDA events (median of warm runs),
     each plain version's once; the element kernel (off the decode path)
     timed on the same batch; each walk kernel's ns and SM cycles per
     decoded row, and the LPC kernel's per row, at the clock nvidia-smi
     reads while it runs;
  6. all three kernels against their plain versions, B=256 packets of
     F=512 (a plain element walk costs its op launches per row, and phases
     5 and 8 hold the kernels at F=4096), tolerance 0, on the inputs the
     decode path gives them: 24-bit
     stereo bytesShifted=1, 32-bit stereo bytesShifted=2, 24-bit mono and
     32-bit mono bytesShifted=1, each batch music ending in a partial
     packet, near-white noise (escapes of 24- and 32-bit samples) and a
     truncated packet; the raw reader signed and unsigned;
  7. the hi-res decode path at full size: B=2048 packets of F=4096 96 kHz
     24-bit stereo music with bytesShifted=1 (87.4 s of audio) through
     BatchDecoder(cfg) on the default device, bytes equal to the source as
     3-byte samples, one packet walk, one LPC, one raw reader (every
     channel's lanes) and one epilogue launch and no element launch, no
     host fallback;
     decode_packets timed as in phase 4;
  8. the packet, LPC and raw reader kernels against their plain versions at
     the shapes phase 7 gave them, tolerance 0; their times by CUDA events beside their bounds
     and the plain versions' times, the LPC's SM cycles a row; the raw
     reader cold (L2 flushed before
     each launch) and warm (20 launches back to back);
  9. 20-bit stereo and 32-bit stereo bytesShifted=2 decodes (B=256), bytes
     equal to the source;
 10. a truncated packet through BatchDecoder(cfg) raises the port's
     DecodeError subclass;
 11. the forward LPC kernel and the encode kernel against their plain
     versions, 256 lanes of F=512 a regime, tolerance 0, on inputs built
     as the encode path builds them: music at orders 4 and 6 (9 taps, int32
     coefficients; order 6 with mode 1; one call of 512 lanes), 12 and 30
     (32 taps, one call), a partial packet, ns == 0, near-white noise at
     chan bits 17 and 32 (escape suffixes of 32 bits), sparse lanes (long
     zero runs) and an all-zero lane; the encode kernel at kb 14 (both
     widths in one call) and at kb 28, and one launch for two channels under
     pbFactor candidates 2, 4 and 7 (a row map, as encode_walk makes it);
 12. the encode path at full size: encode_packets_device(cfg, spec, pcms)
     on the default device for the B=2048 packets of phase 4's 44.1 kHz
     16-bit stereo PCM with EncoderSpec(channel=ChannelSpec(order=6,
     fit=True)); the packets through BatchDecoder(cfg) on the card: bytes
     equal to the source, no host fallback; one forward LPC launch and one
     encode launch for the pair's two channels; total packet
     bytes within 2% of the C++ host
     encoder's; both encoders timed by the host clock (x realtime); one
     call under torch.profiler for the card's busy time and top kernels.  Then
     B=256 packets of 96 kHz 24-bit stereo with bytesShifted=1 the same
     way, and B=256 16-bit packets with pinned coefficients, whose bytes
     equal the C++ host encoder's;
 13. both encode-side kernels against their plain versions on the inputs of
     every launch of one more such call (collected by the path itself: one
     forward LPC launch and one encode launch, each of L=4096 lanes),
     tolerance 0, no lane overflowing its row; kernel times by CUDA events
     (median of warm runs) beside their bounds, each plain version's one
     run, the forward LPC's SM cycles a row and the encode kernel's a
     sample;
     encode_walk alone (the device part of the call) on the call's own
     arguments, by CUDA events; then encode_walk as its process-wide
     program (ops/program.py; the cache emptied first): the call's first
     use eager, its second captured, its third one replay that runs no
     eager encode_walk; a replay's words, bits and ovf equal eager
     encode_walk's on the program's static inputs, byte for byte; the
     capture ms, the pool bytes, the kernels and copies one replay
     enqueues against one eager call (torch.profiler), a replay's time
     and the call's.
 14. the packet kernel (every element of a packet in one launch) against
     its plain version, a host slot loop over the plain element walk, B=256
     packets of F=512 (phase 16 holds it at F=4096), tolerance 0, every
     output on every lane: 8 channels 24-bit bytesShifted=1, and stereo with
     SCE+SCE packets, FIL/DSE elements before the audio and a packet past
     the slot budget; each batch music ending in a partial packet,
     near-white noise, a truncated and two bit-flipped packets;
 15. the multi-slot decode path at full width: B=2048 packets of F=4096
     48 kHz 24-bit 7.1 surround (SCE CPE CPE CPE SCE) with bytesShifted=1
     (174.8 s of audio) through BatchDecoder(cfg) on the default device,
     bytes equal to the source, one packet, one LPC, one raw read and one
     epilogue launch, no host fallback; decode_packets timed as in phase 4;
     one call under torch.profiler (the card's busy time, its top kernels)
     and one with every stage synchronised and timed by the host clock;
 16. at phase 15's shapes, on its batch: the packet kernel against its
     plain version run on the host (`on_host`: five elements a packet,
     eight passes of 4096 rows of op launches, a minute or more), every
     output on every lane; the LPC kernel at
     L=16,384 lanes and the raw read (L=16,384) against their plain versions,
     tolerance 0; their times by CUDA events beside their bounds, the LPC's
     SM cycles a row;
 17. the dense entropy kernel (the walk alone, no parse) on its probe path:
     streams made by the encode kernel, no framing.  Against its plain
     version at B=256, F=512, tolerance 0: two passes at kb 14 (suffix
     widths 17 and 32, start cursors, truncated streams, empty, partial and
     inactive lanes) and one pass at kb 6; at B=2048, F=4096, two passes,
     on the residual rows of phase 5's batch encoded by the encode kernel:
     every output equal to the plain version's, rows equal to what went in,
     end cursor equal to the encoder's bit count; and on phase 4's packets
     themselves, from the entropy start cursors of the element kernel's
     parse: rows and end cursors equal to the element kernel's, and that
     element kernel launch (its count in the JSON line) against its plain
     version at B=2048, F=4096, tolerance 0; its time and bound;
 18. the LPC kernel's other bodies at B=2048, F=4096 (the earlier phases'
     music is order 4, a body of its own): phase 4's PCM at orders 4 and 8
     in turn (each warp runs both orders' bodies), at orders 4 and 7 in
     turn (the general 9-tap loop), and at order 12 with every fourth
     packet order 31, mode 1 (the 32-tap variant); then the forward
     direction on the last two, their decoded rows as the signal; each
     against its plain version, tolerance 0, its time, bound and SM cycles
     a row;
 19. one BatchDecoder(cfg) on the card shared by four threads behind a
     barrier (tests/test_stress_concurrent.py's shared-decoder case;
     `shared_decoder`):
     16-bit stereo F=128 packets, five random slices a thread, and phase
     4's B=2048 F=4096 packets, three a thread; every slice's bytes equal
     to the source, no host fallback;
 20. the facade, the CLI and the corpus service at full size (`facade_phase`),
     on files the port's encode_to_m4a writes on the card: (a) 600 s of
     44.1 kHz 16-bit stereo (6,460 packets of F=4096, the last partial) to
     an .m4a; new_decoder(f).read() equal to the source with windows of 64
     (one packet walk and one LPC launch a window), a second
     new_decoder(f).read() that makes no program, captures nothing and
     runs nothing eagerly (the process-wide cache), timed by the host clock
     with windows of 64 and of 2048 (median of 3 warm runs, x realtime); the
     time to the first MiB after open; a window of 64 one by one
     (decode_async, the card's tail, finish_async) against one
     decode_packets call on all 6,460 packets; the packet walk and the LPC
     against their plain versions, run on the host (`on_host`), on the last
     window of 64 (60 packets, the last partial), tolerance 0; (b) reads of 1 MiB, five
     seeded seeks and one seek_exact, each tail equal to the source,
     decode_file, and the CLI's WAV (header and data); (c) 12 files, half
     M4A and half CAF (4 x 180 s 44.1 kHz 16-bit stereo, 4 x 120 s 96 kHz
     24-bit stereo and 4 x 60 s 48 kHz 24-bit 7.1, both with
     bytesShifted=1) through iter_decode_corpus (batches of 256, 2 in
     flight), each file equal to its source as it comes, one packet launch
     a batch, then timed (median of 3 runs, x realtime; the later passes
     make no program and run nothing eagerly, the second capturing only
     the keys the first ran once); the raw read
     against its plain version (on the host, as (a)'s holds) on the
     service's batch of 256 that spans
     the first two files of the hi-res group and of the 7.1 group,
     tolerance 0; (d) alac-encode
     on a WAV of (a)'s first 60 s, decoded back on the card equal to it.
     No host fallback anywhere.
 21. the paths beside the main one (`new_paths_phase`), at the main paths'
     sizes, tolerance 0 on bytes, no host fallback on clean music, each path
     driven with the launch counts reset just before and read just after:
     (a) phases 4's, 7's and 15's batches through TorchBatchDecoder(cfg):
     bytes equal to the source, one launch of each path kernel a call; H2D
     bytes and decode_packets (median of 5 warm runs); phase 3's ragged
     F=512 batch (partial packet, escapes, orders 12 and 31, two corrupted
     packets): two error lanes or more, the oracle's outcome on them, the
     other packets' bytes equal to the host core's; (b)
     ShardedBatchDecoder over [cuda:0, cuda:0], and over every
     card when there are several, on phase 4's and 15's batches and on
     B=2047: bytes equal to the source, each path kernel once a shard;
     (c) utils.profiling.profile_batch_decode on phase 15's batch, its
     bytes equal to the source (phases 12 and 15 profile
     their call, and phases 15 and 20 time their stages, with the same
     module); (d) phase 4's batch by decode_async, then pcm_to_float,
     log_spectrogram and frame_energy on the card, only the features
     downloaded, against float64 numpy from the source PCM (tolerance
     1e-3), with its time and x realtime; frame_energy and log_spectrogram
     run as programs, a warm call one replay of each, equal to the eager
     formulas; each of the three alone, warm, timed as a program against
     its eager formula (pcm_to_float, which runs directly, as a program
     made there); (e) 16
     packets of phase 4 and 8 of phase 15 through
     PacketDecoder(cfg, "scalar"), and encode_packets(..., backend=
     "python") on 16 packets of phase 4's PCM decoded on the card: bytes
     equal to the source.
 22. the decode programs (`programs_phase`; every decode_async above runs
     through them: a key's first use eager, its second captured as a CUDA
     graph, later ones one replay): (a) on phases 4's, 7's and 15's batches
     and phase 3's ragged batch (at 32 and 9 taps), the third call on a
     key is one replay that runs no eager decode and counts
     its capture's launches once, and its packed, err, ns and wide equal
     `_decode_core`'s eager outputs on the same static inputs, byte for
     byte; bytes equal to the source, the ragged batch's error lanes and
     outcome those of the eager run; (b) each captured shape's capture ms,
     pool bytes (torch.cuda.memory_reserved before and after) and the
     kernels and copies one replay enqueues against one eager call
     (torch.profiler); (c) decode_async's host ms and the card's tail after
     it, eager against replay, on a window of 64 and on phase 4's batch
     (medians of 30 runs in turns); (d) warm B=32 decode_packets latency,
     eager against replay (median and p90 of 30 runs in turns); (e) two
     threads, each on its own CUDA stream, sharing one decoder on phase 4's
     batch and random slices of it: every slice equal to the source.
 23. a corpus of many configs (`corpus_configs_phase`): 16 files, channel
     counts 1, 2, 6 and 8 at 16 and 24 bits (bytesShifted=1), each at 44.1
     and 48 kHz, 612 packets of F=4096 (two full batches of 256 and a
     partial one) written by the port's encode_to_m4a on the card, M4A and
     CAF in turn, through iter_decode_corpus: each file equal to its
     source, no host fallback; after each file the card's reserved bytes
     and the bytes the program cache keeps (static inputs and graph pools),
     which stay within the budget plus the largest single program's; then
     the budget lowered to 256 MiB: programs evicted on the card, the bytes still equal, and the reserved
     bytes after empty_cache falling with what the cache holds (the
     evicted pools returned);
 24. the epilogue kernel against its plain twin (`epilogue_phase`) on the
     inputs a decode call builds from phase 15's 7.1 batch, phase 4's
     16-bit stereo batch and the first 256 packets of phase 7's: 0 differing
     bytes, the path (raw reader and kernel) equal too; the kernel's, the
     path's and the twin's ms by CUDA events beside the kernel's byte bound.
The line before the last is the kernels' JSON record (each kernel's
launches on its path, on phase 20's paths as ``launches_phase20_*``, on
phase 21's as ``launches_phase21_*`` and on phase 23's corpus as
``launches_phase23_corpus``,
max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms); the last line is {"ok": true, "device": {...}}.  Neither JAX
nor the JAX package saprobe_alac_tpu is importable here: both are blocked
before any import.
"""

from __future__ import annotations

import dataclasses
import json
import random
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.modules["jax"] = None  # the port must not need JAX ...
sys.modules["saprobe_alac_tpu"] = None  # ... nor the JAX package

import numpy as np
import torch

SEED = 20261016
F = 4096
RUNS = 5
#: Launches a sample of the LPC's time spans, back to back: its wrapper's
#: host work (~0.1 ms) shows in one launch's events beside a 0.4 ms kernel,
#: and is hidden once launches queue.  Every other kernel's sample is one
#: launch; the LPC's one-launch time is reported too (``ms_one``).
LPC_REPS = 10
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


def music_pcm(n, channels, seed, tonality=0.98, depth=16, dev=None):
    """Music-like PCM at ``depth`` bits, an (n, channels) int64 numpy
    array: correlated tones plus low-level noise (tonality near 0 is
    near-white noise).  With ``dev`` the signal is made there in bulk, its
    noise from torch's generator (phase 20's 680 MB corpus); without, on
    the host from numpy's."""
    if dev is None:
        xp, t, rng = np, np.arange(n), np.random.default_rng(seed)
        noise = lambda: rng.standard_normal(n)  # noqa: E731
    else:
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


def on_host(fn, *args, **kw):
    """(``fn`` on CPU copies of the tensors among its arguments, its outputs
    moved back to their device, ms by the host clock).  A plain version
    walks F rows of small op launches, which take a third of the time on the
    host that they take on the card, and it gives the same integers on
    either."""
    dev = next(a.device for a in args if torch.is_tensor(a))

    def host(a):
        return a.cpu() if torch.is_tensor(a) else a

    t0 = time.perf_counter()
    out = fn(*map(host, args), **{k: host(v) for k, v in kw.items()})
    ms = (time.perf_counter() - t0) * 1e3
    if torch.is_tensor(out):
        return out.to(dev), ms
    return tuple(o.to(dev) for o in out), ms


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


#: Kernels whose ptxas report phase 2 prints: a label and a substring of
#: the mangled name (the LPC kernel's four instantiations,
#: lpc_kernel<TAPS, FWD>).
WALK_KERNELS = {k: k for k in ("element_kernel", "packet_kernel", "dense_entropy_kernel")}
LPC_KERNELS = {
    f"lpc<{taps},{'fwd' if fwd else 'dec'}>": f"lpc_kernelILi{taps}ELb{int(fwd)}E"
    for taps in (9, 32) for fwd in (False, True)
}


def ptxas_report(log: str, kernels: dict) -> dict:
    """Registers, stack and spills of the named kernels, from the build's
    ``-Xptxas -v`` report: {label: "N registers, ... spill ..."}."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = next((k for k, sub in kernels.items() if sub in ln), None)
        elif cur and "stack frame" in ln:
            out[cur] = ln.strip()
        elif cur and "Used" in ln and "registers" in ln:
            out[cur] = ln.split(":", 1)[1].strip() + "; " + out.get(cur, "")
            cur = None
    return out


def sass(so_path, kernels: dict):
    """Each named kernel's SASS in the library (cuobjdump, read once):
    {label: (its instructions, NOPs left out; the instructions in each
    loop, from a backward branch to its target, smallest first)}, or None
    without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", str(so_path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    out, cur, code, labels, branches = {}, None, [], {}, []

    def close():
        if cur is not None:
            loops = [(labels.get(t, t), a) for t, a in branches]
            out[cur] = (code, sorted((a - t) // 16 + 1 for t, a in loops
                                     if isinstance(t, int) and t <= a))

    pending = []
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            close()
            cur = next((k for k, sub in kernels.items() if sub in m.group(1)), None)
            code, labels, branches, pending = [], {}, [], []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if not m or cur is None:
            continue
        addr, op = int(m.group(1), 16), m.group(2).strip()
        if not op.startswith("NOP"):
            code.append(op)
        for lab in pending:
            labels[lab] = addr
        pending = []
        b = re.search(r"\bBRA\b[^`(]*(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", op)
        if b:
            branches.append((b.group(1) or int(b.group(2), 16), addr))
    close()
    return out


#: The encode and raw reader kernels, for phase 2's ptxas and SASS counts.
ENCODE_KERNELS = {"encode": "encode_kernel"}
RAW_KERNELS = {"raw_read": "raw_reader_kernel"}
#: The epilogue kernel's instantiations, epilogue_kernel<DEPTH, VEC>.
EPILOGUE_KERNELS = {f"epilogue<{d},{v}>": f"epilogue_kernelILi{d}ELb{int(v)}E"
                    for d in (16, 20, 24, 32) for v in (False, True)}


#: The opcodes of the card's integer divide sequence (a float reciprocal
#: estimate of the divisor): none may appear in the encode kernel.
DIVIDE_OPS = ("MUFU.RCP", "I2F.U32.RP")


def walk_clock(fn, rows, ms):
    """(ns, SM cycles, the clock in MHz) per row of a kernel that took
    ``ms`` with ``rows`` rows a thread, at the SM clock nvidia-smi reads
    while the kernel runs: launches of fn() are queued from before nvidia-smi
    starts until it has answered, a few at a time, so the card is busy
    for the whole read."""
    for _ in range(4):
        fn()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        stdout=subprocess.PIPE, text=True,
    )
    try:
        t_end = time.monotonic() + 60
        while smi.poll() is None and time.monotonic() < t_end:
            for _ in range(4):
                fn()
            torch.cuda.synchronize()
        out, _ = smi.communicate(timeout=10)
    finally:
        if smi.poll() is None:
            smi.kill()
            smi.wait()
    torch.cuda.synchronize()
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi clocks.sm failed: exit {smi.returncode}")
    mhz = float(out.split()[0])
    return ms * 1e6 / rows, ms * 1e-3 * mhz * 1e6 / rows, mhz


def lpc_diff(a, b, ns):
    """Max abs difference of LPC outputs over rows t < ns of each lane."""
    valid = torch.arange(a.shape[0], device=a.device)[:, None] < ns[None, :]
    return amax((a - b).abs()[valid])


def lanes(w, channels=2):
    """The LPC kernel's inputs as the main path builds them from a walk."""
    from saprobe_alac_tpu_torch.ops.lpc import lpc_lanes

    L = w.ns.numel() * channels
    lane = (
        w.order.T.reshape(L), w.mode.T.reshape(L), w.den.T.reshape(L),
        w.cb.T.reshape(L), w.ns.repeat(channels), w.coefs.transpose(0, 1).reshape(L, 32),
    )
    return (w.res, *lpc_lanes(*lane))


def packet_args(c, words, sizes):
    """The packet kernel's inputs as walk_batch builds them."""
    from saprobe_alac_tpu_torch.codec.element import CHANNEL_LAYOUT_OFFSETS

    offsets = torch.tensor(CHANNEL_LAYOUT_OFFSETS[c.num_channels - 1], dtype=torch.int32,
                           device=words.device)
    kw = dict(kb=c.kb, F=c.frame_length, C=c.num_channels, depth=c.bit_depth, pb_cfg=c.pb,
              mb_cfg=c.mb)
    return (words, sizes, offsets), kw


def packet_diff(got, want):
    """Max abs difference over every output of the packet walk, every lane
    (error lanes too: both run the same walk)."""
    return max(amax((a.to(torch.int64) - b.to(torch.int64)).abs()) for a, b in zip(got, want))


def hold_batch(c, packets, dev, kernels):
    """The decode path's kernels named in ``kernels`` ("packet", "lpc",
    "raw_read") against their plain versions, tolerance 0, on the inputs
    one `decode_async` call on ``packets`` builds (its staged words, its
    packet walk, the LPC lanes at 9 taps, the shift region's reads), the
    plain versions on the host (`on_host`).  Raises on any difference;
    returns {name: plain ms}."""
    from saprobe_alac_tpu_torch.ops import lpc_kernel, walk_kernel
    from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder
    from saprobe_alac_tpu_torch.ops.epilogue import shift_reads
    from saprobe_alac_tpu_torch.ops.raw_reader import raw_read, raw_read_reference
    from saprobe_alac_tpu_torch.ops.walk import walk_batch

    Fc, Cc = c.frame_length, c.num_channels
    words, sizes = TorchBatchDecoder(c, dev)._stage(packets)
    w = walk_batch(words, sizes, F=Fc, C=Cc, depth=c.bit_depth, pb=c.pb, mb=c.mb, kb=c.kb)
    err, plain = {}, {}
    if "packet" in kernels:
        args, kw = packet_args(c, words, sizes)
        want, plain["packet"] = on_host(walk_kernel.dense_packet_reference, *args, **kw)
        err["packet"] = packet_diff(walk_kernel.dense_packet(*args, **kw), want)
    if "lpc" in kernels:
        lin = lanes(w, Cc)
        want, plain["lpc"] = on_host(lpc_kernel.lpc_fir_reference, *lin, F=Fc, taps=9)
        err["lpc"] = lpc_diff(lpc_kernel.lpc_fir(*lin, F=Fc, taps=9), want, w.ns.repeat(Cc))
    if "raw_read" in kernels:
        r = shift_reads(w.shift_base, w.bs, w.role, w.ns)
        if not bool((r[3] != 0).any()):
            raise AssertionError(f"{len(packets)} packets at {c.bit_depth} bits: no raw read")
        want, plain["raw_read"] = on_host(raw_read_reference, words, *r[:5], F=Fc, row=r[5])
        err["raw_read"] = amax((raw_read(words, *r[:5], F=Fc, row=r[5]) - want).abs())
    if any(err.values()):
        raise AssertionError(f"{len(packets)} packets of {Cc} channels at {c.bit_depth} bits: "
                             f"kernels differ from their plain versions {err}")
    return plain


def epilogue_phase(tag, dev, batches, runs=RUNS):
    """Phase 24: the epilogue kernel against its plain twin on the card, for
    each of ``batches`` ({label: (config, packets)}), on the inputs one
    `decode_async` call builds (its staged words, the packet walk, the LPC
    at 9 taps, the raw reader's output for the shift region): the PCM rows
    byte for byte (0 differing bytes, the twin's dtype and shape), and
    `epilogue.epilogue` (the raw reader and the kernel) equal too.  Then,
    by CUDA events (median of ``runs`` samples of one call): the kernel;
    the path (raw reader and kernel); the twin (`extract_shift`, its raw
    read included, and `finish_packed`); and the kernel's bound: the LPC's
    samples, the raw lanes it reads (bs > 0, not a V channel), the six
    fields and the rows, each once.  Returns {label: numbers}."""
    from saprobe_alac_tpu_torch.ops import lpc_kernel
    from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder
    from saprobe_alac_tpu_torch.native import BYTES_PER_SAMPLE
    from saprobe_alac_tpu_torch.ops.epilogue import (
        epilogue, epilogue_kernel, extract_shift, finish_packed, shift_reads,
    )
    from saprobe_alac_tpu_torch.ops.raw_reader import raw_read
    from saprobe_alac_tpu_torch.ops.walk import walk_batch

    res, lines = {}, []
    for label, (c, packets) in batches.items():
        Fc, Cc, depth = c.frame_length, c.num_channels, c.bit_depth
        shift = depth in (24, 32)
        words, sizes = TorchBatchDecoder(c, dev)._stage(packets)
        w = walk_batch(words, sizes, F=Fc, C=Cc, depth=depth, pb=c.pb, mb=c.mb, kb=c.kb)
        mix = lpc_kernel.lpc_fir(*lanes(w, Cc), F=Fc, taps=9)[:Fc]
        fields = (w.bs, w.mixbits, w.mixres, w.role, w.out_chan, w.filled)
        raw = None
        if shift:
            *reads, row = shift_reads(w.shift_base, w.bs, w.role, w.ns)
            raw = raw_read(words, *reads, F=Fc, row=row)

        def kernel():
            return epilogue_kernel(mix, raw, *fields, C=Cc, depth=depth)

        def path():
            return epilogue(words, mix, w, F=Fc, C=Cc, depth=depth)

        def twin():
            vals = None
            if shift:
                vals = extract_shift(words, w.shift_base, w.bs, w.role, w.ns, F=Fc, C=Cc)
            return finish_packed(mix, vals, *fields, C=Cc, depth=depth)

        got, want = kernel(), twin()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"phase 24 {label}: the kernel's rows {got.dtype} "
                                 f"{tuple(got.shape)}, the twin's {want.dtype} {tuple(want.shape)}")
        # The twin's 16-bit rows are a transposed view; its bytes as the download
        # copies them are its contiguous copy's.
        differ = int((got.view(torch.uint8) != want.contiguous().view(torch.uint8)).sum())
        if differ or not torch.equal(path(), want):
            raise AssertionError(f"phase 24 {label}: {differ} bytes of the epilogue kernel "
                                 "differ from its plain twin's (or the path's from the kernel's)")
        del got, want
        t_kernel, t_path, t_twin = (cuda_times(fn, runs) for fn in (kernel, path, twin))
        B = words.shape[0]
        raw_lanes = int(((w.bs > 0) & (w.role != 2)).sum()) if shift else 0
        nbytes = (4 * (mix.numel() + Fc * raw_lanes + len(fields) * B * Cc)
                  + B * Fc * Cc * BYTES_PER_SAMPLE[depth])
        kb, by = bound(nbytes, 0)
        res[label] = {"B": B, "C": Cc, "depth": depth, "differing_bytes": differ,
                      "ms": statistics.median(t_kernel), "ms_path": statistics.median(t_path),
                      "plain_ms": statistics.median(t_twin), "bound_ms": kb, "bound_by": by,
                      "bytes": nbytes}
        lines.append(f"{label} (B={B}): differing bytes {differ}; kernel ms "
                     f"{summary(t_kernel)} | raw reader and kernel {summary(t_path)} | twin "
                     f"{summary(t_twin)} | bound {kb:.4f} by {by} ({nbytes} bytes)")
        del words, sizes, w, mix, raw
    print(f"phase 24 {tag} epilogue kernel vs its plain twin, tolerance 0: " + "; ".join(lines))
    return res


def shared_decoder(port, c, packets, pcm_all, slices, seed, threads=4):
    """Phase 19 (tests/test_stress_concurrent.py's shared-decoder case):
    ``threads`` threads behind a barrier, each decoding ``slices`` random
    slices of ``packets`` with one ``port.BatchDecoder(c)`` on the card.
    Raises unless every slice's bytes equal the source; returns the packets
    decoded."""
    src = pcm_bytes(pcm_all, c.bit_depth)
    per = len(src) // len(pcm_all) * c.frame_length
    expected = [src[i * per : (i + 1) * per] for i in range(len(packets))]
    dec_s = port.BatchDecoder(c)
    barrier = threading.Barrier(threads)

    def worker(k):
        rng = random.Random(seed + k)
        barrier.wait()
        bad, n_dec = [], 0
        for _ in range(slices):
            lo = rng.randrange(0, len(packets) - 1)
            hi = rng.randrange(lo + 1, len(packets) + 1)
            out = dec_s.decode_packets(packets[lo:hi])
            bad += [i for i, o in zip(range(lo, hi), out) if o != expected[i]]
            n_dec += hi - lo
        return bad, n_dec

    with ThreadPoolExecutor(threads) as pool:
        runs = list(pool.map(worker, range(threads)))
    bad = sorted({i for b, _ in runs for i in b})
    if bad or dec_s.impl.last_fallbacks:
        raise AssertionError(f"shared BatchDecoder: packets {bad[:8]} differ from the "
                             f"source ({dec_s.impl.last_fallbacks} host fallbacks)")
    return sum(n for _, n in runs)


#: Phase 20's corpus: (seconds, sample rate, depth, channels, bytesShifted),
#: four files each, every second one a CAF.
CORPUS = [(180, 44100, 16, 2, 0)] * 4 + [(120, 96000, 24, 2, 1)] * 4 + [(60, 48000, 24, 8, 1)] * 4


def facade_phase(port, tag, dev, scale=1.0, frame=F, runs=3):
    """Phase 20: the facade, the CLI and the corpus service at full size, on
    files the port's encoder writes on ``dev``; every entry point is called
    with ``backend``/``device`` set to ``dev`` (the card: their default).
    Raises on any byte that differs from the source and on any host
    fallback.  Returns the phase's numbers and its launches on each path."""
    import tempfile

    from saprobe_alac_tpu_torch import cli as port_cli
    from saprobe_alac_tpu_torch.encoder import EncoderSpec, encode_to_m4a
    from saprobe_alac_tpu_torch.ops import program
    from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder
    from saprobe_alac_tpu_torch.utils.profiling import stage_timer
    from saprobe_alac_tpu_torch.utils.wav import wav_header, write_wav

    backend = dev.type
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    # Host fallbacks summed over every window and batch of the phase.
    fallbacks = [0]
    plain_finish = TorchBatchDecoder.finish_async

    def counted_finish(self, handle, packets):
        out = plain_finish(self, handle, packets)
        fallbacks[0] += self.last_fallbacks
        return out

    def no_fallbacks(where):
        if fallbacks[0]:
            raise AssertionError(f"phase 20 {where}: {fallbacks[0]} packets decoded on the host")

    def launched(where, names, counts):
        """The path kernels' launches, and the decode programs' replays."""
        missing = [k for k in names if counts[k] == 0]
        if missing:
            raise AssertionError(f"phase 20 {where}: no launch of {missing} ({counts})")
        return {k: counts[k] for k in (*names, "replay")}

    def program_runs():
        """What the decode programs did since the last reset: programs
        made, eager runs, captures, replays, evictions."""
        c = program.counts(dev)
        return {k: c[k] for k in ("programs", "eager", "captures", "replays", "evictions")}

    res, launches = {}, {}
    # The phase, and its corpus below, start with an empty program cache:
    # the earlier phases' programs would pass its budget on the way.
    program.clear()
    TorchBatchDecoder.finish_async = counted_finish
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    try:
        d = Path(tmp.name)
        # ---- (a) one album-length track through the facade ----
        rate, C = 44100, 2
        n_a = int(600 * rate * scale)
        fmt = port.PCMFormat(rate, 16, C)
        pcm_a = music_pcm(n_a, C, SEED + 20, dev=dev)
        src = pcm_bytes(pcm_a, 16)
        port.reset_launch_counts()
        t0 = time.perf_counter()
        blob = encode_to_m4a(fmt, pcm_a, frame_length=frame, backend=backend)
        res["encode_s"] = time.perf_counter() - t0
        launches["encode_to_m4a"] = launched(
            "encode_to_m4a", ("lpc_forward", "encode"), port.launch_counts())
        track = d / "track.m4a"
        track.write_bytes(blob)
        n_pk = -(-n_a // frame)

        def read_all(batch_size):
            with open(track, "rb") as fh:
                return port.new_decoder(fh, backend=backend, batch_size=batch_size).read()

        port.reset_launch_counts()
        program.reset_counts()
        if read_all(64) != src:
            raise AssertionError("phase 20 track: the facade's bytes differ from the source")
        launches["track"] = launched("track", ("packet", "lpc", "epilogue"), port.launch_counts())
        res["programs_first_decoder"] = program_runs()
        no_fallbacks("track")
        windows = -(-n_pk // 64)
        if launches["track"]["packet"] != windows:
            raise AssertionError(f"phase 20 track: {launches['track']} launches for "
                                 f"{windows} windows")
        # A second decoder on the track finds every program its windows need
        # in the process-wide cache: it makes none, captures nothing and
        # runs nothing eagerly.
        program.reset_counts()
        if read_all(64) != src:
            raise AssertionError("phase 20 track: the second decoder's bytes differ")
        second = res["programs_second_decoder"] = program_runs()
        if (second["programs"], second["captures"], second["eager"]) != (0, 0, 0):
            raise AssertionError(f"phase 20 track: the second decoder's programs {second}, "
                                 "want no program made, no capture and no eager run")
        audio_a = n_a / rate
        for bsz in (64, 2048):
            if bsz != 64 and read_all(bsz) != src:
                raise AssertionError(f"phase 20 track, windows of {bsz}: bytes differ")
            ts = []
            for _ in range(runs):
                t0 = time.perf_counter()
                read_all(bsz)
                ts.append(time.perf_counter() - t0)
            res[f"read_s_batch{bsz}"] = summary(ts)
            res[f"x_realtime_batch{bsz}"] = audio_a / statistics.median(ts)
        first = []
        for _ in range(runs):
            t0 = time.perf_counter()
            with open(track, "rb") as fh:
                chunk = port.new_decoder(fh, backend=backend).read(1 << 20)
            first.append((time.perf_counter() - t0) * 1e3)
            if chunk != src[: 1 << 20]:
                raise AssertionError("phase 20 track: the first MiB differs")
        res["first_mib_ms"] = summary(first)
        no_fallbacks("track, timed reads")
        # Where a window's time goes: decode_async (staging, upload, launches)
        # on the host, then the card's tail, then finish_async (download,
        # trim); against one decode_packets call on the whole track.
        with open(track, "rb") as fh:
            cfg_a, samples = port.demux_stream(fh)
            packets = []
            for info in samples:
                fh.seek(info.offset)
                packets.append(fh.read(info.size))
        bd = port.BatchDecoder(cfg_a, dev)
        stage, tail, finish, pcm_w = [], [], [], []
        for lo in range(0, n_pk, 64):
            win = packets[lo : lo + 64]
            t0 = time.perf_counter()
            h = bd.decode_async(win)
            t1 = time.perf_counter()
            sync()
            t2 = time.perf_counter()
            pcm_w += bd.finish_async(h, win)
            t3 = time.perf_counter()
            stage.append((t1 - t0) * 1e3)
            tail.append((t2 - t1) * 1e3)
            finish.append((t3 - t2) * 1e3)
        if b"".join(pcm_w) != src:
            raise AssertionError("phase 20 track: windows decoded one by one differ")
        del pcm_w
        res["window64_ms"] = {"decode_async": summary(stage), "card_tail": summary(tail),
                              "finish_async": summary(finish),
                              "sum_s": (sum(stage) + sum(tail) + sum(finish)) / 1e3}
        if b"".join(bd.decode_packets(packets)) != src:
            raise AssertionError("phase 20 track: one decode_packets call differs")
        one = host_times(lambda: bd.decode_packets(packets), runs=runs)
        res["one_call_s"] = summary(one)
        no_fallbacks("track, windows")
        # The same two ways, their host stages read from the port's spans:
        # summed over the 101 windows of 64, and for the one call.
        pcm_w = []
        with stage_timer() as win_t:
            for lo in range(0, n_pk, 64):
                pcm_w += bd.decode_packets(packets[lo : lo + 64])
        with stage_timer() as one_t:
            one_out = bd.decode_packets(packets)
        if b"".join(pcm_w) != src or b"".join(one_out) != src:
            raise AssertionError("phase 20 track: a decode under the profiler differs")
        del pcm_w, one_out
        win_st = res["stages_ms_windows64_sum"] = win_t.ms()
        one_st = res["stages_ms_one_call"] = one_t.ms()
        # The kernels of the last window (a partial one, the last packet
        # partial) against their plain versions.
        res["plain_ms_window64"] = hold_batch(cfg_a, packets[(n_pk - 1) // 64 * 64 :], dev,
                                              ("packet", "lpc"))
        print(
            f"phase 20 {tag} (a) facade, {audio_a:.1f} s of 44.1 kHz 16-bit stereo ({n_pk} "
            f"packets of F={frame}, the last partial, {len(src)} bytes of PCM) encoded on the "
            f"card by encode_to_m4a in {res['encode_s']:.3f} s (launches "
            f"{launches['encode_to_m4a']}); new_decoder(f).read() == source, host fallbacks 0, "
            f"launches {launches['track']} ({windows} windows of 64), programs "
            f"{res['programs_first_decoder']}; a second new_decoder(f).read() == source, "
            f"programs {res['programs_second_decoder']}; read s (median of {runs} "
            f"warm runs): windows of 64 {res['read_s_batch64']} = "
            f"{res['x_realtime_batch64']:.1f}x realtime, windows of 2048 "
            f"{res['read_s_batch2048']} = {res['x_realtime_batch2048']:.1f}x (earlier runs on "
            f"an H100 80GB HBM3 at 700 W: 0.481 s with programs kept per decoder, 0.404 s "
            f"before decode programs); first MiB after "
            f"open, ms {res['first_mib_ms']}; a window of 64 one by one, ms: decode_async "
            f"{res['window64_ms']['decode_async']}, the card's tail after it "
            f"{res['window64_ms']['card_tail']}, finish_async {res['window64_ms']['finish_async']}"
            f" (sum {res['window64_ms']['sum_s']:.3f} s); one decode_packets call on all "
            f"{n_pk} packets, s {res['one_call_s']}; host stages (the port's spans, ms), summed "
            f"over the windows of 64: { {k: round(v, 1) for k, v in win_st.items()} }, the one "
            f"call: { {k: round(v, 1) for k, v in one_st.items()} }; the last window's "
            f"packet walk and LPC vs plain: max_abs_err 0 (plain on the host, ms "
            f"{ {k: round(v, 1) for k, v in res['plain_ms_window64'].items()} })"
        )

        # ---- (b) streaming reads, seeks, decode_file, the CLI ----
        with open(track, "rb") as fh:
            dec = port.new_decoder(fh, backend=backend)
            chunks = []
            while chunk := dec.read(1 << 20):
                chunks.append(chunk)
            if b"".join(chunks) != src:
                raise AssertionError("phase 20 (b): reads of 1 MiB differ from the source")
            del chunks
            rng = random.Random(SEED)
            bpf, seeks = 2 * C, []
            for _ in range(5):
                pos = dec.seek(rng.uniform(0, dec.duration()))
                at = round(pos * rate)
                if at % frame or dec.read() != src[at * bpf :]:
                    raise AssertionError(f"phase 20 (b): the tail after seek({pos}) differs")
                seeks.append(at)
            t_exact = (rng.randrange(n_a - frame) + 0.5) / rate
            at = round(dec.seek_exact(t_exact) * rate)
            if at != int(t_exact * rate) or dec.read() != src[at * bpf :]:
                raise AssertionError(f"phase 20 (b): the tail after seek_exact({t_exact}) differs")
        fmt_f, samples_f = port.decode_file(str(track), backend=backend)
        if fmt_f != fmt or not np.array_equal(samples_f, pcm_a):
            raise AssertionError("phase 20 (b): decode_file differs from the source")
        del samples_f
        wav_out = d / "track.wav"
        t0 = time.perf_counter()
        rc = port_cli.main(["-format", "wav", "-backend", backend, str(track), str(wav_out)])
        res["cli_wav_s"] = time.perf_counter() - t0
        got = wav_out.read_bytes()
        if rc != 0 or got[:44] != wav_header(fmt, len(src)) or got[44:] != src:
            raise AssertionError(f"phase 20 (b): the CLI's WAV differs (rc {rc})")
        del got
        no_fallbacks("(b)")
        print(
            f"phase 20 {tag} (b) reads of 1 MiB == source; 5 seeks (frames {seeks}) and "
            f"seek_exact to frame {at}: each tail == source; decode_file == source; "
            f"cli main -format wav: header == wav_header, data == source, "
            f"{res['cli_wav_s']:.3f} s; host fallbacks 0"
        )

        # ---- (c) a corpus of 12 files through the service ----
        paths, specs = [], []
        t0 = time.perf_counter()
        for i, (sec, r, depth, ch, bs) in enumerate(CORPUS):
            n = int(sec * r * scale)
            pcm = music_pcm(n, ch, SEED + 200 + i, depth=depth, dev=dev)
            paths.append(d / f"c{i}.{'caf' if i % 2 else 'm4a'}")
            paths[-1].write_bytes(encode_to_m4a(
                port.PCMFormat(r, depth, ch), pcm, frame_length=frame,
                spec=EncoderSpec(bytes_shifted=bs), container=paths[-1].suffix[1:],
                backend=backend))
            specs.append((n, ch, SEED + 200 + i, depth, r))
        del pcm
        res["corpus_encode_s"] = time.perf_counter() - t0
        audio_c = sum(n / r for n, _, _, _, r in specs)
        pcm_c = sum(n * ch * (2 if dp == 16 else 3) for n, ch, _, dp, _ in specs)
        seen = set()
        port.reset_launch_counts()
        program.clear()
        program.reset_counts()
        uses = {id(p): p.uses for p in program.programs(dev)}
        for f in port.iter_decode_corpus(paths, backend=backend):
            n, ch, seed, depth, _ = specs[f.index]
            if f.index in seen or f.pcm != pcm_bytes(music_pcm(n, ch, seed, depth=depth, dev=dev), depth):
                raise AssertionError(f"phase 20 (c): file {f.index} differs from its source")
            seen.add(f.index)
        launches["corpus"] = launched("corpus", ("packet", "lpc", "raw_read", "epilogue"),
                                      port.launch_counts())
        res["programs_corpus_pass1"] = program_runs()
        # The first pass's keys that ran once: a key's second use captures.
        once = sum(1 for p in program.programs(dev)
                   if p.kind == "decode" and p.graph is None and p.uses > uses.get(id(p), 0))
        if seen != set(range(len(paths))):
            raise AssertionError(f"phase 20 (c): files {sorted(seen)} came back")
        no_fallbacks("(c)")
        # The raw read on the service's batch of 256 that holds the last
        # packet of each group's first file (and the next file's first ones).
        res["plain_ms_raw_read_corpus"] = {}
        for first, label in ((4, "hires"), (8, "7.1")):
            group_pk, cfgs = [], []
            for path in paths[first : first + 2]:
                with open(path, "rb") as fh:
                    cfg_g, samples = port.demux_stream(fh)
                    cfgs.append((cfg_g, len(samples)))
                    for info in samples:
                        fh.seek(info.offset)
                        group_pk.append(fh.read(info.size))
            if cfgs[0][0] != cfgs[1][0]:
                raise AssertionError(f"phase 20 (c): files {first} and {first + 1} differ in config")
            at = (cfgs[0][1] - 1) // 256 * 256
            res["plain_ms_raw_read_corpus"][label] = hold_batch(
                cfg_g, group_pk[at : at + 256], dev, ("raw_read",))["raw_read"]
            del group_pk
        per_group = {}
        for n, ch, _, depth, r in specs:
            per_group[(ch, depth, r)] = per_group.get((ch, depth, r), 0) + -(-n // frame)
        batches = sum(-(-p // 256) for p in per_group.values())
        if launches["corpus"]["packet"] != batches:
            raise AssertionError(f"phase 20 (c): {launches['corpus']} launches, {batches} batches")
        ts, passes = [], []
        for _ in range(runs):
            program.reset_counts()
            t0 = time.perf_counter()
            got = sum(len(f.pcm) for f in port.iter_decode_corpus(paths, backend=backend))
            ts.append(time.perf_counter() - t0)
            passes.append(program_runs())
            if got != pcm_c:
                raise AssertionError(f"phase 20 (c): {got} bytes of PCM, not {pcm_c}")
        no_fallbacks("(c), timed")
        # Later passes run the first pass's programs: no program made, no
        # eager run; the second pass captures only the keys the first ran
        # once, and a third pass captures nothing.
        want = [(0, once, 0)] + [(0, 0, 0)] * (runs - 1)
        if [(c["programs"] + c["eager"], c["captures"], c["evictions"]) for c in passes] != want:
            raise AssertionError(f"phase 20 (c): the passes' programs {passes}; want (made + "
                                 f"eager, captures, evictions) {want}")
        res["programs_corpus_later_passes"] = passes
        res["corpus_s"] = summary(ts)
        res["corpus_x_realtime"] = audio_c / statistics.median(ts)
        res["corpus_batches"] = batches
        print(
            f"phase 20 {tag} (c) iter_decode_corpus over {len(paths)} files (half M4A, half CAF; "
            f"{audio_c:.1f} s of audio, {pcm_c} bytes of PCM; encoded on the card in "
            f"{res['corpus_encode_s']:.3f} s): each file == its source as it came, host "
            f"fallbacks 0, {batches} batches of up to 256, launches {launches['corpus']}, "
            f"programs {res['programs_corpus_pass1']} ({once} keys ran once); the later passes' "
            f"programs {passes}; s "
            f"(median of {runs} runs) {res['corpus_s']} = {res['corpus_x_realtime']:.1f}x "
            f"realtime; raw read vs plain on a cross-file batch of 256, hi-res and 7.1: "
            f"max_abs_err 0 (plain on the host, ms {res['plain_ms_raw_read_corpus']})"
        )

        # ---- (d) alac-encode on a WAV of the track's first 60 s ----
        n_d = min(n_a, int(60 * rate))
        wav_in, m4a_out = d / "in.wav", d / "enc.m4a"
        with open(wav_in, "wb") as fh:
            write_wav(fh, fmt, src[: n_d * 4])
        port.reset_launch_counts()
        rc = port_cli.encode_main(["-frame", str(frame), "-backend", backend, str(wav_in),
                                   str(m4a_out)])
        launches["alac_encode"] = launched(
            "alac-encode", ("lpc_forward", "encode"), port.launch_counts())
        with open(m4a_out, "rb") as fh:
            back = port.new_decoder(fh, backend=backend).read()
        if rc != 0 or back != src[: n_d * 4]:
            raise AssertionError(f"phase 20 (d): alac-encode's file does not decode to its WAV "
                                 f"(rc {rc})")
        no_fallbacks("(d)")
        print(f"phase 20 {tag} (d) alac-encode of {n_d / rate:.1f} s ({m4a_out.stat().st_size} "
              f"bytes, launches {launches['alac_encode']}) decoded on the card == its WAV")
    finally:
        TorchBatchDecoder.finish_async = plain_finish
        tmp.cleanup()
    return res, launches


def new_paths_phase(port, tag, dev, batches, ragged, runs=RUNS):
    """Phase 21: the port's paths beside the main decode path, on the card
    at the main paths' sizes.  ``batches``: {label: (config, packets, source
    PCM)} for phase 4's, phase 7's and phase 15's batches (label "16-bit
    stereo" and "7.1" among them); ``ragged``: phase 3's (config, packets).
    Every path is driven with the launch counts set to 0 just before it and
    read just after; any byte that differs from the source, any host
    fallback on clean music and any path kernel not launched raises.
    Returns the phase's numbers and its launches on each path."""
    from saprobe_alac_tpu_torch.encoder import EncoderSpec, encode_packets
    from saprobe_alac_tpu_torch.ops import audio, program
    from saprobe_alac_tpu_torch.ops.audio import frame_energy, log_spectrogram, pcm_to_float
    from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder
    from saprobe_alac_tpu_torch.parallel import ShardedBatchDecoder
    from saprobe_alac_tpu_torch.utils.profiling import profile_batch_decode

    res, launches = {}, {}

    def kernels_of(c):
        return ("packet", "lpc", "epilogue") + (("raw_read",) if c.bit_depth in (24, 32) else ())

    def launched(where, path, c, per=1):
        """The path kernels' launches since the last reset: ``per`` each."""
        counts = port.launch_counts()
        got = {k: counts[k] for k in kernels_of(c)}
        if any(n != per for n in got.values()):
            raise AssertionError(f"phase 21 {where}: launches {counts}, want {per} of each "
                                 f"of {kernels_of(c)}")
        total = launches.setdefault(path, {"packet": 0, "lpc": 0, "raw_read": 0, "epilogue": 0,
                                           "replay": 0})
        for k, n in (*got.items(), ("replay", counts["replay"])):
            total[k] += n

    def clean(where, *decoders):
        if any(d.last_fallbacks for d in decoders):
            raise AssertionError(f"phase 21 {where}: host fallbacks on clean music")

    def outcome(fn):
        try:
            return fn()
        except port.AlacError as exc:
            return type(exc).__name__

    # ---- (a) the main paths' batches and phase 3's ragged one ----
    lines = []
    for label, (c, pk, pcm) in batches.items():
        dec = TorchBatchDecoder(c, dev)
        port.reset_launch_counts()
        out = dec.decode_packets(pk)
        launched(f"(a) {label}", "padded", c)
        check_decode(out, pcm, c.bit_depth)
        clean(f"(a) {label}", dec)
        del out
        words, sizes, _ = dec._host_stage(pk)
        r = {"h2d_bytes": words.nbytes + sizes.nbytes,
             "s": summary(host_times(lambda: dec.decode_packets(pk), runs=runs))}
        res[f"padded_{label}"] = r
        lines.append(f"{label}: H2D bytes {r['h2d_bytes']}; decode_packets median s "
                     f"{r['s']['median']:.4f}")
    c3, pk3 = ragged
    dec = TorchBatchDecoder(c3, dev)
    h = dec.decode_async(pk3)
    bad = torch.nonzero(h[1][: len(pk3)].cpu()).flatten().tolist()
    if len(bad) < 2:
        raise AssertionError(f"phase 21 (a) ragged: error lanes {bad}, want 2 or more")
    got = outcome(lambda: dec.finish_async(h, pk3))
    want = outcome(lambda: port.BatchDecoder(c3, "scalar").decode_packets([pk3[i] for i in bad]))
    good = [p for i, p in enumerate(pk3) if i not in bad]
    if (got if isinstance(got, str) else [got[i] for i in bad]) != want or dec.decode_packets(
            good) != port.BatchDecoder(c3, "native").decode_packets(good):
        raise AssertionError("phase 21 (a) ragged: the decode differs from the oracle's")
    res["ragged"] = {"packets": len(pk3), "error_lanes": bad,
                     "outcome": got if isinstance(got, str) else "bytes"}
    print(f"phase 21 {tag} (a) TorchBatchDecoder(cfg): bytes == source, launches 1 packet, "
          f"1 lpc, 1 epilogue (1 raw read at 24 bits) a call, host fallbacks 0; " + "; ".join(lines)
          + f"; ragged F={c3.frame_length} B={len(pk3)} (partial packet, escapes, orders 12 "
          f"and 31): error lanes {bad}, the oracle's outcome ({res['ragged']['outcome']}), the "
          f"{len(good)} other packets' bytes == the host core's")

    # ---- (b) the packet-axis sharded decoder ----
    c4, pk4, pcm4 = batches["16-bit stereo"]
    inputs = {"16-bit stereo": batches["16-bit stereo"], "7.1": batches["7.1"],
              "16-bit stereo B=2047": (c4, pk4[:2047], pcm4[: 2047 * F])}
    meshes = {"2 shards on cuda:0": [dev, dev]}
    if torch.cuda.device_count() > 1:
        meshes[f"{torch.cuda.device_count()} cards"] = None
    lines = []
    for mesh_label, mesh in meshes.items():
        for label, (c, pk, pcm) in inputs.items():
            sd = ShardedBatchDecoder(c, mesh)
            port.reset_launch_counts()
            out = sd.decode_packets(pk)
            launched(f"(b) {mesh_label} {label}", "sharded", c, per=len(sd.devices))
            check_decode(out, pcm, c.bit_depth)
            clean(f"(b) {mesh_label} {label}", sd)
            del out
            t = summary(host_times(lambda: sd.decode_packets(pk), runs=3))
            res[f"sharded_{mesh_label}_{label}_s"] = t
            lines.append(f"{mesh_label}, {label}: median {t['median']:.4f} s")
    n_cards = max(1, torch.cuda.device_count())  # every mesh above: on one card, and on all
    res["sharded_cards"] = n_cards
    print(f"phase 21 {tag} (b) ShardedBatchDecoder on {n_cards} card(s): bytes == source, each "
          f"path kernel once a shard, host fallbacks 0; " + "; ".join(lines))

    # ---- (c) the profiler on phase 15's batch ----
    c71, pk71, pcm71 = batches["7.1"]
    port.reset_launch_counts()
    timer, out = profile_batch_decode(c71, pk71, iters=1, device=dev)
    launched("(c) profile_batch_decode", "profiler", c71, per=3)  # 2 warm + 1
    check_decode(out, pcm71, 24)
    del out
    res["profile_71_ms"] = timer.ms()
    print(f"phase 21 {tag} (c) profile_batch_decode(7.1, iters=1), bytes == source, ms: "
          f"{json.dumps(res['profile_71_ms'])}")

    # ---- (d) device-resident features of phase 4's batch ----
    dec = TorchBatchDecoder(c4, dev)
    n_pk = len(pk4)

    frame, hop, n_bins = 512, 256, 128

    def samples_of(packed):
        return packed[:n_pk].contiguous().view(torch.int16).reshape(n_pk, F, 2)

    def features():
        packed, err, _, wide = dec.decode_async(pk4)
        mono = pcm_to_float(samples_of(packed), 16).mean(dim=-1)
        feats = log_spectrogram(mono, frame, hop, n_bins)
        energy = frame_energy(mono, frame, hop)
        return feats.cpu(), energy.cpu(), err[:n_pk].cpu(), wide[:n_pk].cpu()

    port.reset_launch_counts()
    feats, energy, err, wide = features()
    launched("(d) features", "features", c4)
    if bool(err.any()) or bool(wide.any()):
        raise AssertionError("phase 21 (d): a packet of clean music needs the host or 32 taps")
    src = np.zeros((n_pk * F, 2))
    src[: len(pcm4)] = pcm4
    mono = (src / 32768.0).mean(axis=-1).reshape(n_pk, F)
    idx = np.arange(1 + (F - frame) // hop)[:, None] * hop + np.arange(frame)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(frame) / frame)
    want = np.log1p(np.abs(np.fft.rfft(mono[:, idx] * win, axis=-1))[..., :n_bins])
    want_e = np.sqrt((mono[:, idx] ** 2).mean(axis=-1) + 1e-12)
    f_err = float(np.abs(feats.double().numpy() - want).max())
    e_err = float(np.abs(energy.double().numpy() - want_e).max())
    if max(f_err, e_err) > 1e-3:
        raise AssertionError(f"phase 21 (d): features differ from float64 numpy by {f_err} "
                             f"(spectrogram), {e_err} (frame energy)")
    t = host_times(features, runs=runs)
    # The framed features run as programs: after the timed calls each has
    # captured, so one more is one replay of each, equal to the eager
    # formulas on the same samples (pcm_to_float runs directly).
    samples = samples_of(dec.decode_async(pk4)[0])
    program.reset_counts()
    f_mono = pcm_to_float(samples, 16)
    got = (log_spectrogram(f_mono.mean(dim=-1), frame, hop, n_bins),
           frame_energy(f_mono.mean(dim=-1), frame, hop))
    c = program.counts(dev)
    ran = {k: c[k] for k in ("programs", "eager", "captures", "replays")}
    if ran != {"programs": 0, "eager": 0, "captures": 0, "replays": 2}:
        raise AssertionError(f"phase 21 (d): the features' programs ran {ran}, want 2 replays")
    e_mono = audio._to_float(samples, 16).mean(dim=-1)
    eager = (audio._log_spec(e_mono, audio._frame_index(F, frame, hop, dev),
                             audio._hann(frame, torch.float32, dev), n_bins),
             audio._energy(e_mono, audio._frame_index(F, frame, hop, dev)))
    if not all(torch.equal(a, b) for a, b in zip(got, eager)):
        raise AssertionError("phase 21 (d): the features' replays differ from the eager formulas")
    progs = {p.kind: p for p in program.programs(dev)
             if p.kind in ("log_spectrogram", "frame_energy")}
    # Each feature alone on this batch, warm, through a program (a fill of
    # its static input, one replay, a clone of its output; pcm_to_float's
    # made here, as the function runs directly) against its eager formula
    # (the index and window built anew, as before the programs): ms by CUDA
    # events, 10 calls back to back a sample, in turns.
    x_mono = f_mono.mean(dim=-1)
    variants = {
        "pcm_to_float": (
            lambda: audio._run("pcm_to_float", (16,), samples, lambda s: audio._to_float(s, 16)),
            lambda: audio._to_float(samples, 16)),
        "frame_energy": (
            lambda: frame_energy(x_mono, frame, hop),
            lambda: audio._energy(x_mono, audio._frame_index(F, frame, hop, dev))),
        "log_spectrogram": (
            lambda: log_spectrogram(x_mono, frame, hop, n_bins),
            lambda: audio._log_spec(x_mono, audio._frame_index(F, frame, hop, dev),
                                    audio._hann(frame, torch.float32, dev), n_bins)),
    }
    alone = {}
    for name, (as_program, as_eager) in variants.items():
        if not torch.equal(as_program(), as_eager()):
            raise AssertionError(f"phase 21 (d): {name}'s program differs from its formula")
        tp, te = [], []
        for first in (True, False):
            for fn, out in ((as_program, tp), (as_eager, te))[:: 1 if first else -1]:
                out += cuda_times(fn, reps=10)
        alone[name] = {"program_ms": summary(tp), "eager_ms": summary(te)}
    audio_s = len(pcm4) / c4.sample_rate
    res["features"] = {"max_abs_err": f_err, "max_abs_err_energy": e_err, "s": summary(t),
                       "feature_bytes": feats.numel() * 4, "pcm_bytes": n_pk * F * 4,
                       "x_realtime": audio_s / statistics.median(t), "alone": alone,
                       "programs": {k: {"capture_ms": p.capture_ms, "pool_bytes": p.pool_bytes,
                                        "uses": p.uses} for k, p in progs.items()}}
    print(f"phase 21 {tag} (d) decode_async + pcm_to_float + log_spectrogram and frame_energy "
          f"on the card, B={n_pk}: features {tuple(feats.shape)}, {tuple(energy.shape)} "
          f"max_abs_err {f_err:.3g}, {e_err:.3g} against float64 numpy (tolerance 1e-3); each "
          f"framed feature a program, a warm call one replay of each (2), == the eager "
          f"formulas; "
          f"{res['features']['programs']}; each alone, warm, program against eager formula, "
          f"median ms: "
          f"{ {k: (v['program_ms']['median'], v['eager_ms']['median']) for k, v in alone.items()} }"
          f"; decode+features median "
          f"{statistics.median(t) * 1e3:.1f} ms, x realtime {res['features']['x_realtime']:.1f}; "
          f"{feats.numel() * 4} feature bytes back for {n_pk * F * 4} bytes of PCM")

    # ---- (e) the host backends: the scalar oracle and the Python encoder ----
    t0 = time.perf_counter()
    pd = port.PacketDecoder(c4, "scalar")
    check_decode([pd.decode_packet(p) for p in pk4[:16]], pcm4[: 16 * F], 16)
    t1 = time.perf_counter()
    pd = port.PacketDecoder(c71, "scalar")
    check_decode([pd.decode_packet(p) for p in pk71[:8]], pcm71[: 8 * F], 24)
    t2 = time.perf_counter()
    pk_py = encode_packets(c4, EncoderSpec(), pcm4[: 16 * F], backend="python")
    t3 = time.perf_counter()
    dec = TorchBatchDecoder(c4, dev)
    port.reset_launch_counts()
    out = dec.decode_packets(pk_py)
    launched("(e) the Python encoder's packets", "python_encoder", c4)
    check_decode(out, pcm4[: 16 * F], 16)
    clean("(e)", dec)
    res["host"] = {"scalar_stereo_s_per_packet": (t1 - t0) / 16,
                   "scalar_71_s_per_packet": (t2 - t1) / 8,
                   "python_encode_s_per_packet": (t3 - t2) / 16,
                   "python_packet_bytes": sum(map(len, pk_py)),
                   "native_packet_bytes": sum(map(len, pk4[:16]))}
    print(f"phase 21 {tag} (e) PacketDecoder(cfg, 'scalar'): 16 stereo packets == source "
          f"({(t1 - t0) / 16:.3f} s a packet), 8 7.1 packets == source ({(t2 - t1) / 8:.3f} s a "
          f"packet); encode_packets(backend='python'), 16 packets ({(t3 - t2) / 16:.3f} s a "
          f"packet, {res['host']['python_packet_bytes']} bytes against the C++ core's "
          f"{res['host']['native_packet_bytes']}), decoded on the card == source")
    return res, launches


def enqueued(fns):
    """One torch.profiler session over ``fns`` ({label: fn}): each fn once to
    warm the profiler, then once inside a marker that ends in a
    synchronise.  Returns {label: {"kernels", "kernel_ms", "copies",
    "copy_ms"}}: the device events that started inside the label's marker
    (kernels; copies and memsets) and their summed device ms, or None where
    the profiler saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        for label, fn in fns.items():
            with record_function(f"enqueued::{label}"):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    out = {}
    for label in fns:
        mark = next(e for e in events if e.name == f"enqueued::{label}"
                    and e.device_type != DeviceType.CUDA)
        n, us = {"kernels": 0, "copies": 0}, {"kernels": 0.0, "copies": 0.0}
        for e in events:
            if (e.device_type != DeviceType.CUDA or e.name.startswith("enqueued::")
                    or not mark.time_range.start <= e.time_range.start <= mark.time_range.end):
                continue
            kind = "copies" if e.name.startswith(("Memcpy", "Memset")) else "kernels"
            n[kind] += 1
            us[kind] += e.time_range.elapsed_us()
        out[label] = {"kernels": n["kernels"], "kernel_ms": us["kernels"] / 1e3,
                      "copies": n["copies"], "copy_ms": us["copies"] / 1e3} if any(
                          n.values()) else None
    return out


def enqueue_times(fns, runs):
    """{label: {"host_ms", "tail_ms"}} of ``fns`` ({label: fn}) in turns
    (the order reversed every run): the host's ms inside fn(), and the
    card's ms after it until a synchronise returns; medians of ``runs``."""
    ts = {label: ([], []) for label in fns}
    for r in range(runs):
        for label in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[label]()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ts[label][0].append((t1 - t0) * 1e3)
            ts[label][1].append((t2 - t1) * 1e3)
    return {label: {"host_ms": statistics.median(h), "tail_ms": statistics.median(t),
                    "host_ms_min": min(h), "host_ms_max": max(h)}
            for label, (h, t) in ts.items()}


def encode_program_check(port, w_args, w_kw, dev, call):
    """Phase 13: `encode_walk` as its process-wide program (ops/program.py).
    ``w_args``, ``w_kw``: what one `encode_packets_device` call handed
    `encode_walk`; ``call()`` makes that call.  With the cache emptied,
    three calls: the first runs eagerly, the second captures, the third is
    one replay that runs no eager `encode_walk` and counts its capture's
    launches once.  Then a replay's words, bits and ovf against eager
    `encode_walk` on the program's static inputs, byte for byte, and what
    one replay and one eager call enqueue.  Raises on any difference;
    returns (its numbers, the program's graph)."""
    from saprobe_alac_tpu_torch.ops import encode_device, program

    program.clear()
    steps = []
    for _ in range(3):
        program.reset_counts()
        port.reset_launch_counts()
        call()
        c = program.counts(dev)
        steps.append(({k: c[k] for k in ("programs", "eager", "captures", "replays")},
                      {k: n for k, n in port.launch_counts().items() if n}))
    (prog,) = [p for p in program.programs(dev) if p.kind == "encode_walk"]
    want = [{"programs": 1, "eager": 1, "captures": 0, "replays": 0},
            {"programs": 0, "eager": 0, "captures": 1, "replays": 1},
            {"programs": 0, "eager": 0, "captures": 0, "replays": 1}]
    if [c for c, _ in steps] != want or steps[2][1] != dict(prog.launches, replay=1):
        raise AssertionError(f"phase 13 encode program: calls {steps}, want {want} and the "
                             f"third call's launches {dict(prog.launches, replay=1)}")
    sources = tuple(a.cpu().numpy() for a in w_args)
    got = encode_device.encode_walk_program(sources, dev, **w_kw)
    eager = encode_device.encode_walk(*prog.inputs, **w_kw)
    for name, a, b in zip(("words", "bits", "ovf"), got, eager):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"phase 13 encode program: the replay's {name} differs from "
                                 "eager encode_walk's")
    seen = enqueued({
        "replay": lambda: encode_device.encode_walk_program(sources, dev, **w_kw),
        "eager": lambda: encode_device.encode_walk(*prog.inputs, **w_kw),
    })
    return {"key": [str(prog.device), prog.kind, repr(prog.statics), list(prog.shape)],
            "capture_ms": prog.capture_ms, "pool_bytes": prog.pool_bytes,
            "launches": prog.launches, "third_call_launches": steps[2][1],
            "enqueued": seen}, prog.graph


def programs_phase(port, tag, dev, batches, ragged, runs=30):
    """Phase 22: the decode programs (ops/program.py) on the card.
    ``batches``: {label: (config, packets, source PCM)} for phase 4's,
    phase 7's and phase 15's batches ("16-bit stereo" among them);
    ``ragged``: phase 3's (config, packets).  (a) On each batch (the
    ragged one at 9 and 32 taps): the key's first use runs
    eagerly, the second captures, the third is one replay that calls no
    eager decode and counts its kernels once; the replay's four outputs
    equal `_decode_core`'s eager outputs on the same static inputs, byte
    for byte; the bytes equal the source (the ragged batch: the same error
    lanes and outcome as the eager run).  (b) Each captured shape's capture
    ms, pool bytes, and the kernels and copies one replay enqueues against
    one eager call (torch.profiler).  (c) decode_async's host ms and the
    card's tail after it, eager against replay, on a window of 64 of phase
    20's track shape and on phase 4's batch.  (d) Warm B=32 decode_packets
    latency, eager against replay.  (e) Two threads, each on its own
    stream, share one decoder on phase 4's batch.  Raises on any
    difference.  Returns the phase's numbers."""
    from saprobe_alac_tpu_torch.ops import program
    from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder
    from saprobe_alac_tpu_torch.ops.walk import ERR_NONE

    res = {"shapes": {}}
    # Every key starts here: a key's first use in the process runs eagerly.
    program.clear()

    def program_of(dec, pk, taps=9):
        """The process-wide program that ``dec`` runs ``pk`` through."""
        shape = (*dec._host_stage(pk)[0].shape, taps)
        (prog,) = [p for p in program.programs(dev)
                   if (p.kind, p.statics, p.shape) == ("decode", dec.statics, shape)]
        return prog

    def outcome(fn):
        try:
            return fn()
        except port.AlacError as exc:
            return type(exc).__name__

    def through_programs(label, dec, pk, taps=9):
        """Three decode_async calls on one key: eager, capture, replay.
        Returns (program, the replay's handle, its eager twin)."""
        dec.decode_async(pk, taps=taps)
        prog = program_of(dec, pk, taps)
        if prog.graph is not None or prog.uses != 1:
            raise AssertionError(f"phase 22 (a) {label}: the first use was not eager")
        dec.decode_async(pk, taps=taps)
        if prog.graph is None:
            raise AssertionError(f"phase 22 (a) {label}: the second use did not capture")
        core, eager_calls = prog.core, [0]

        def counted(*a):
            eager_calls[0] += 1
            return core(*a)

        prog.core = counted
        port.reset_launch_counts()
        handle = dec.decode_async(pk, taps=taps)
        counts = port.launch_counts()
        prog.core = core
        want = dict(prog.launches, replay=1)
        if eager_calls[0] or {k: n for k, n in counts.items() if n} != want:
            raise AssertionError(f"phase 22 (a) {label}: a warm call ran {eager_calls[0]} eager "
                                 f"decodes, launches {counts}, want {want}")
        eager = core(*prog.inputs)
        for name, a, b in zip(("packed", "err", "ns", "wide"), handle, eager):
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"phase 22 (a) {label}: the replay's {name} differs from "
                                     "the eager run's")
        res["shapes"][label] = {"key": list(prog.shape), "capture_ms": prog.capture_ms,
                                "pool_bytes": prog.pool_bytes, "launches": prog.launches}
        return prog, handle, eager

    # ---- (a) replay against eager, byte for byte ----
    progs = {}
    for label, (c, pk, pcm) in batches.items():
        dec = TorchBatchDecoder(c, dev)
        prog, handle, _ = through_programs(label, dec, pk)
        check_decode(dec.finish_async(handle, pk), pcm, c.bit_depth)
        if dec.last_fallbacks:
            raise AssertionError(f"phase 22 (a) {label}: host fallbacks on clean music")
        progs[label] = (dec, prog, pk)
    c3, pk3 = ragged
    dec = TorchBatchDecoder(c3, dev)
    lanes = None
    # 32 taps first: the 9-tap handle's finish_async re-runs at 32.
    for taps in (32, 9):
        name = f"ragged taps {taps}"
        prog, handle, eager = through_programs(name, dec, pk3, taps)
        bad = torch.nonzero(handle[1][: len(pk3)] != ERR_NONE).flatten().tolist()
        if len(bad) < 2 or (lanes is not None and bad != lanes):
            raise AssertionError(f"phase 22 (a) {name}: error lanes {bad}")
        lanes = bad
        got = outcome(lambda: dec.finish_async(handle, pk3))
        if got != outcome(lambda: dec.finish_async(eager, pk3)):
            raise AssertionError(f"phase 22 (a) {name}: the outcome differs from eager")
        progs[name] = (dec, prog, pk3)
    res["ragged"] = {"error_lanes": lanes, "outcome": got if isinstance(got, str) else "bytes"}
    print(f"phase 22 {tag} (a) programs: on phases 4, 7 and 15's B=2048 batches and phase 3's "
          f"ragged batch (9 and 32 taps), the first use ran eagerly, the second captured, the "
          f"third was one replay (launches = the capture's, replay 1, no eager decode) whose "
          f"packed, err, ns and wide == _decode_core's eager outputs on the same static "
          f"inputs; bytes == source, host fallbacks 0; ragged: error lanes "
          f"{res['ragged']['error_lanes']}, outcome {res['ragged']['outcome']} == eager's")

    # ---- (b) each shape: capture, pool, kernels a replay against an eager call ----
    fns = {}
    for name, (dec, prog, pk) in progs.items():
        taps = prog.shape[2]
        fns[f"{name} replay"] = lambda dec=dec, pk=pk, taps=taps: dec.decode_async(pk, taps=taps)
        fns[f"{name} eager"] = lambda prog=prog: prog.core(*prog.inputs)
    seen = enqueued(fns)
    for name, (dec, prog, pk) in progs.items():
        shape = res["shapes"][name]
        shape["replay"], shape["eager"] = seen[f"{name} replay"], seen[f"{name} eager"]
        shape["kernels_by_launch_counts"] = sum(prog.launches.values())
    print(f"phase 22 {tag} (b) each shape: capture ms, pool bytes (torch.cuda.memory_reserved "
          "before and after), kernels and copies one replay (decode_async) enqueues against one "
          "eager _decode_core call (torch.profiler; None: no device event seen): " + "; ".join(
              f"{name}: capture {s['capture_ms']:.1f} ms, pool {s['pool_bytes']}, replay "
              f"{s['replay']}, eager {s['eager']}" for name, s in res["shapes"].items()))
    program.clear()
    del progs, fns

    # ---- (c) decode_async on the host and the card's tail: eager against replay ----
    c4, pk4, pcm4 = batches["16-bit stereo"]
    for label, pk in (("window64", pk4[:64]), ("B2048", pk4)):
        dec = TorchBatchDecoder(c4, dev)
        dec.decode_async(pk)
        prog = program_of(dec, pk)
        res[f"enqueue_{label}"] = enqueue_times({
            "eager": lambda dec=dec, pk=pk, prog=prog: prog.core(*dec._stage(pk)),
            "replay": lambda dec=dec, pk=pk: dec.decode_async(pk),
        }, runs=max(20, runs // 2 * 2))
    print(f"phase 22 {tag} (c) decode_async, ms (medians of {max(20, runs // 2 * 2)} runs in "
          f"turns): window of 64 (16-bit stereo F={F}, phase 20's track shape) "
          f"{json.dumps(res['enqueue_window64'])}; B={len(pk4)} {json.dumps(res['enqueue_B2048'])}")

    # ---- (d) warm B=32 decode_packets latency: eager against replay ----
    pk32 = pk4[:32]
    dec = TorchBatchDecoder(c4, dev)
    check_decode(dec.decode_packets(pk32), pcm4[: 32 * F], 16)
    prog = program_of(dec, pk32)
    ways = {"eager": lambda: dec.finish_async(prog.core(*dec._stage(pk32)), pk32),
            "replay": lambda: dec.decode_packets(pk32)}
    for fn in ways.values():
        check_decode(fn(), pcm4[: 32 * F], 16)
    lat = {k: [] for k in ways}
    for r in range(runs):
        for k in (list(ways) if r % 2 == 0 else list(ways)[::-1]):
            t0 = time.perf_counter()
            ways[k]()
            lat[k].append((time.perf_counter() - t0) * 1e3)
    res["latency_warm_b32_ms"] = {
        k: {"median": statistics.median(v), "p90": float(np.percentile(v, 90)), "min": min(v)}
        for k, v in lat.items()}
    print(f"phase 22 {tag} (d) warm B=32 F={F} 16-bit stereo decode_packets, ms ({runs} runs "
          f"in turns): {json.dumps(res['latency_warm_b32_ms'])}")

    # ---- (e) two threads, each on its own stream, one decoder ----
    src = pcm_bytes(pcm4, 16)
    per = len(src) // len(pcm4) * F
    shared = TorchBatchDecoder(c4, dev)
    barrier = threading.Barrier(2)

    def worker(k):
        stream = torch.cuda.Stream()
        rng = random.Random(SEED + 22 + k)
        bad, n_dec = [], 0
        barrier.wait()
        with torch.cuda.stream(stream):
            for i in range(6):
                lo, hi = (0, len(pk4)) if i % 2 == 0 else sorted(rng.sample(range(len(pk4) + 1), 2))
                out = shared.decode_packets(pk4[lo:hi])
                bad += [j for j, o in zip(range(lo, hi), out) if o != src[j * per : (j + 1) * per]]
                n_dec += hi - lo
        return bad, n_dec

    with ThreadPoolExecutor(2) as pool:
        runs_e = list(pool.map(worker, range(2)))
    bad = sorted({j for b, _ in runs_e for j in b})
    if bad or shared.last_fallbacks:
        raise AssertionError(f"phase 22 (e): packets {bad[:8]} differ from the source on two "
                             f"streams ({shared.last_fallbacks} host fallbacks)")
    mine = [p for p in program.programs(dev) if (p.kind, p.statics) == ("decode", shared.statics)]
    res["two_streams"] = {"packets": sum(n for _, n in runs_e),
                          "programs": [list(p.shape) for p in mine],
                          "uses": [p.uses for p in mine]}
    print(f"phase 22 {tag} (e) two threads on two streams, one decoder, phase 4's batch and "
          f"random slices ({res['two_streams']['packets']} packets): every slice == source, host "
          f"fallbacks 0; programs {res['two_streams']['programs']} used "
          f"{res['two_streams']['uses']} times")
    return res


#: Phase 23's corpus: one file a config, (channels, depth, sample rate):
#: channel counts 1, 2, 6 and 8 at 16 and 24 bits (bytesShifted=1), each at
#: two sample rates (configs that differ only in rate share programs).
CONFIGS23 = [(ch, depth, rate) for ch in (1, 2, 6, 8) for depth in (16, 24)
             for rate in (44100, 48000)]
#: Phase 23's packets a file: two full batches of the service's 256 and a
#: partial one, so each config has a full key (used twice a file) and a
#: partial one.
PACKETS23 = 2 * 256 + 100
#: Phase 23's lowered budget (bytes) for its eviction sub-step: well below
#: what the corpus's programs hold at the default budget (0.94 GB on an H100
#: since the epilogue kernel; 2.95 GB before it, against 1 GiB then), so
#: the pass evicts several times the check's slack.
LOW_BUDGET23 = 1 << 28


def corpus_configs_phase(port, tag, dev, frame=F, packets=PACKETS23, low_budget=LOW_BUDGET23):
    """Phase 23: a corpus of many configs through the service and the
    process-wide program cache.  One file a config of `CONFIGS23`, written
    by the port's encoder on ``dev``, ``packets`` packets of ``frame``
    samples each (the last partial), M4A and CAF in turn, decoded through
    iter_decode_corpus: each file equal to its source, no host fallback.
    After each file: torch.cuda.memory_reserved and the resident pool
    bytes, which must stay within the budget plus the largest single pool.
    Then a pass with the budget set to ``low_budget``: programs are evicted,
    their memory returns after empty_cache, and the bytes stay equal.
    Returns (the phase's numbers, its launches)."""
    import gc
    import tempfile

    from saprobe_alac_tpu_torch.encoder import EncoderSpec, encode_to_m4a
    from saprobe_alac_tpu_torch.ops import program
    from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder

    cuda = dev.type == "cuda"

    def reserved():
        return torch.cuda.memory_reserved(dev) if cuda else 0

    def resident():
        """Bytes the cached programs keep on the device: inputs and pools."""
        return program.counts(dev)["resident_bytes"]

    fallbacks = [0]
    plain_finish = TorchBatchDecoder.finish_async

    def counted_finish(self, handle, pk):
        out = plain_finish(self, handle, pk)
        fallbacks[0] += self.last_fallbacks
        return out

    res = {"files": []}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke23_")
    TorchBatchDecoder.finish_async = counted_finish
    try:
        d = Path(tmp.name)
        paths, sources = [], []
        t0 = time.perf_counter()
        for i, (ch, depth, rate) in enumerate(CONFIGS23):
            n = packets * frame - frame // 3
            pcm = music_pcm(n, ch, SEED + 230 + i, depth=depth, dev=dev)
            paths.append(d / f"k{i}.{'caf' if i % 2 else 'm4a'}")
            paths[-1].write_bytes(encode_to_m4a(
                port.PCMFormat(rate, depth, ch), pcm, frame_length=frame,
                spec=EncoderSpec(bytes_shifted=int(depth == 24)),
                container=paths[-1].suffix[1:], backend=dev.type))
            sources.append(pcm_bytes(pcm, depth))
        del pcm
        res["encode_s"] = time.perf_counter() - t0

        def decode_pass(label, limit):
            """One pass over the corpus: bytes against the sources, the
            memory after each file, the bound at each file.  Returns the
            files' memory trajectory and the largest program's bytes."""
            seen, steps, largest = set(), [], 0
            for f in port.iter_decode_corpus(paths, backend=dev.type):
                if f.index in seen or f.pcm != sources[f.index]:
                    raise AssertionError(f"phase 23 {label}: file {f.index} differs from its "
                                         "source")
                seen.add(f.index)
                largest = max([largest, *(p.resident_bytes for p in program.programs(dev))])
                r = resident()
                steps.append({"file": f.index, "reserved": reserved(), "resident_bytes": r})
                if r > limit + largest:
                    raise AssertionError(f"phase 23 {label}: resident {r} bytes past the budget "
                                         f"{limit} plus the largest program {largest}")
            if seen != set(range(len(paths))):
                raise AssertionError(f"phase 23 {label}: files {sorted(seen)} came back")
            if fallbacks[0]:
                raise AssertionError(f"phase 23 {label}: {fallbacks[0]} packets decoded on the "
                                     "host")
            return steps, largest

        # ---- the corpus at the default budget ----
        program.clear()
        program.reset_counts()
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        res["reserved_before"] = reserved()
        limit = program.budget(dev)
        port.reset_launch_counts()
        t0 = time.perf_counter()
        res["files"], res["largest_program"] = decode_pass("default budget", limit)
        res["decode_s"] = time.perf_counter() - t0
        counts = port.launch_counts()
        launches = {k: counts[k] for k in ("packet", "lpc", "raw_read", "epilogue", "replay")}
        missing = [k for k in ("packet", "lpc", "raw_read", "epilogue") if counts[k] == 0]
        if missing:
            raise AssertionError(f"phase 23: no launch of {missing} ({counts})")
        res["budget"] = limit
        c = program.counts(dev)
        res["programs"] = {k: c[k] for k in ("programs", "eager", "captures", "replays",
                                             "evictions", "cached", "resident_bytes")}
        res["decode_statics"] = len({p.statics for p in program.programs(dev)
                                     if p.kind == "decode"})
        print(f"phase 23 {tag} (a) {len(paths)} files (channels 1, 2, 6, 8 at 16 and 24 bits, "
              f"each at 44.1 and 48 kHz; {packets} packets of F={frame} each; encoded on the "
              f"card in {res['encode_s']:.3f} s) through iter_decode_corpus in "
              f"{res['decode_s']:.3f} s: each file == its source, host fallbacks 0, launches "
              f"{launches}; budget {limit}; programs {res['programs']}; decode statics "
              f"{res['decode_statics']}; memory after each file (reserved, the cache's resident "
              f"bytes): {[(s['reserved'], s['resident_bytes']) for s in res['files']]}; the "
              f"largest program {res['largest_program']}")

        # ---- (b) a lowered budget: eviction on the card ----
        evicted = [0]
        plain_release = program.Program.release

        def counted_release(self):
            evicted[0] += self.resident_bytes
            plain_release(self)

        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        r0, held0 = reserved(), resident()
        program.reset_counts()
        program.Program.release = counted_release
        program.BUDGET = low_budget
        try:
            res["low_files"], res["low_largest_program"] = decode_pass("low budget", low_budget)
        finally:
            program.BUDGET = None
            program.Program.release = plain_release
        c = program.counts(dev)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        r1, held1 = reserved(), resident()
        res["low"] = {"budget": low_budget, "evictions": c["evictions"], "evicted_bytes":
                      evicted[0], "reserved_before": r0, "reserved_after": r1,
                      "held_before": held0, "held_after": held1,
                      "programs": {k: c[k] for k in ("programs", "eager", "captures", "replays",
                                                     "cached", "resident_bytes")}}
        # Memory not returned would leave the evicted pools reserved: the
        # rise in reserved bytes would pass the rise in what the cache holds
        # by about the evicted pools' bytes.
        slack = 256 << 20
        if c["evictions"] == 0 or (cuda and evicted[0] < 4 * slack):
            raise AssertionError(f"phase 23 (b): budget {low_budget} evicted {c['evictions']} "
                                 f"programs ({evicted[0]} bytes)")
        if r1 - r0 > held1 - held0 + slack:
            raise AssertionError(f"phase 23 (b): reserved rose {r1 - r0} bytes, the cache's "
                                 f"programs {held1 - held0}: evicted pools not returned")
        print(f"phase 23 {tag} (b) budget {low_budget}: each file == its source, host fallbacks "
              f"0; {c['evictions']} programs evicted ({evicted[0]} bytes); after "
              f"empty_cache reserved {r0} -> {r1} bytes while the cache's programs (inputs and "
              f"pools) went {held0} -> {held1}; programs {res['low']['programs']}; memory after "
              f"each file: {[(s['reserved'], s['resident_bytes']) for s in res['low_files']]}")
        program.clear()
    finally:
        TorchBatchDecoder.finish_async = plain_finish
        tmp.cleanup()
    return res, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import saprobe_alac_tpu_torch as port
    from saprobe_alac_tpu_torch import _build, native
    from saprobe_alac_tpu_torch.ops import encode_device, encode_kernel, lpc_kernel, walk_kernel
    from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder
    from saprobe_alac_tpu_torch.ops.epilogue import shift_reads
    from saprobe_alac_tpu_torch.ops.raw_reader import raw_read, raw_read_reference
    from saprobe_alac_tpu_torch.ops.walk import walk_batch
    from saprobe_alac_tpu_torch.utils.profiling import profile_call, stage_timer

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
    walk_regs = ptxas_report(_build.build_log(), WALK_KERNELS)
    print(f"phase 2 walk kernels (ptxas): {walk_regs}")
    lpc_regs = ptxas_report(_build.build_log(), LPC_KERNELS)
    lpc_listing = sass(_build._OUT / "liblpc_kernel.so", LPC_KERNELS)
    lpc_sass = lpc_listing and {k: loops for k, (_, loops) in lpc_listing.items()}
    print(
        f"phase 2 lpc kernel (ptxas): {lpc_regs}; SASS instructions in each loop (rows a trip: "
        f"8 in every 9-tap body and each order's body at 32 taps, 1 in the 32-tap general "
        f"loop): {lpc_sass if lpc_sass is not None else 'not measured (no cuobjdump)'}"
    )

    er_regs = ptxas_report(_build.build_log(), {**ENCODE_KERNELS, **RAW_KERNELS})
    ep_regs = ptxas_report(_build.build_log(), EPILOGUE_KERNELS)
    print(f"phase 2 epilogue kernel (ptxas): {ep_regs}")
    er_listing = {
        label: (sass(_build._OUT / f"lib{sub}.so", kernels) or {}).get(label, (None, None))
        for kernels in (ENCODE_KERNELS, RAW_KERNELS) for label, sub in kernels.items()
    }
    er_sass = {label: code and len(code) for label, (code, _) in er_listing.items()}
    enc_code, enc_loops = er_listing["encode"]
    divides = None if enc_code is None else sum(
        any(d in op for d in DIVIDE_OPS) for op in enc_code)
    if divides:
        raise AssertionError(f"the encode kernel's SASS holds {divides} divide instructions")
    print(
        f"phase 2 encode and raw reader kernels (ptxas): {er_regs}; SASS instructions (NOPs "
        f"left out) {er_sass}; the encode kernel's loops {enc_loops} (a trip of its sample "
        f"loop codes kAhead samples; the raw reader has no loop, each thread reads kRows "
        f"rows); divide instructions ({', '.join(DIVIDE_OPS)}) in the encode kernel: "
        f"{'not measured (no cuobjdump)' if divides is None else divides}"
    )

    cfg = port.PacketConfig(
        frame_length=F, bit_depth=16, num_channels=2, pb=40, mb=10, kb=14,
        max_run=255, max_frame_bytes=0, avg_bit_rate=0, sample_rate=44100,
    )
    C = 2
    i32, i64 = torch.int32, torch.int64
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

    def check_walk_lpc(c, words, sizes, w, walker="element"):
        """A walk kernel (the element kernel, or the packet kernel the
        decode path runs) and the 9-tap LPC kernel against their plain
        versions on one batch: (walk err, LPC err, walk plain ms, LPC plain
        ms, error lanes)."""
        ch, Fc = c.num_channels, c.frame_length
        if walker == "element":
            args, kw = element_args(words, sizes, ch, Fc), element_kw(c)
            want, el_ms = timed(lambda: walk_kernel.dense_element_reference(*args, **kw))
            e = element_diff(walk_kernel.dense_element(*args, **kw), want, walk_kernel.M_NS)
            n_err = int((want[2] != 0).sum())
        else:
            args, kw = packet_args(c, words, sizes)
            want, el_ms = timed(lambda: walk_kernel.dense_packet_reference(*args, **kw))
            e = packet_diff(walk_kernel.dense_packet(*args, **kw), want)
            n_err = int((want[1] != 0).sum())
        lin = lanes(w, ch)
        want_l, lpc_ms = timed(lambda: lpc_kernel.lpc_fir_reference(*lin, F=Fc, taps=9))
        lp = lpc_diff(lpc_kernel.lpc_fir(*lin, F=Fc, taps=9), want_l, w.ns.repeat(ch))
        if e != 0 or lp != 0:
            raise AssertionError(
                f"{c.bit_depth}-bit C={ch} B={words.shape[0]}: {walker} {e}, LPC {lp} "
                "against their plain versions"
            )
        return e, lp, el_ms, lpc_ms, n_err

    # ---- phase 3: kernels against their plain versions (B=256) ----
    # Packets of F3 samples: a plain element walk costs its op launches per
    # row whatever B is, and phases 5 and 8 hold the kernels at F=4096.
    F3 = 512
    cfg3 = dataclasses.replace(cfg, frame_length=F3)
    pk = []
    for i, (kw, ton, n) in enumerate([
        ({}, 0.98, 60 * F3 + 321),  # ends in a partial packet
        ({}, 0.0, 60 * F3),  # near-white noise: escapes
        ({"order": 12}, 0.98, 60 * F3),
        ({"order": 31, "mode": 1}, 0.98, 76 * F3),
    ]):
        pk += native.encode_packets(cfg3, music_pcm(n, C, SEED + i, ton), **kw)
    pk = pk[:254]
    rng = np.random.default_rng(SEED)
    bad0 = pk[3][: len(pk[3]) // 3]  # truncated
    bad1 = bytearray(pk[4])
    for i in range(1, 40, 3):  # bit flips; byte 1 holds unused header bits
        bad1[i] ^= 1 << int(rng.integers(0, 8))
    pk += [bad0, bytes(bad1)]
    assert len(pk) == 256
    ragged3 = (cfg3, pk)  # phases 21 and 22 decode it whole
    words, sizes = stager._stage(pk)
    B = words.shape[0]
    w = walk(cfg3, words, sizes)
    if not (w.order == 12).any() or not (w.order == 31).any() or not (w.esc == 1).any():
        raise AssertionError("phase 3 batch lacks order-12, order-31 or escape lanes")
    e_err, l_err, el_plain_256, _, n_err = check_walk_lpc(cfg3, words, sizes, w)
    if n_err < 2:
        raise AssertionError(f"expected the corrupted packets to flag an error, got {n_err}")
    lpc_in = lanes(w)
    a = lpc_kernel.lpc_fir(*lpc_in, F=F3, taps=32)
    b, plain_ms_32 = timed(lambda: lpc_kernel.lpc_fir_reference(*lpc_in, F=F3, taps=32))
    l_err = max(l_err, lpc_diff(a, b, w.ns.repeat(C)))
    if l_err != 0:
        raise AssertionError(f"LPC kernel (32 taps) differs from its plain version: {l_err}")
    t_l32 = cuda_times(lambda: lpc_kernel.lpc_fir(*lpc_in, F=F3, taps=32), reps=LPC_REPS)
    print(
        f"phase 3 kernels vs plain (B={B}, F={F3}, stereo, tolerance 0): element "
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
    # One packet walk for every C: the element kernel is off the decode path.
    if (launches["packet"], launches["lpc"], launches["epilogue"], launches["element"]) != (
            1, 1, 1, 0):
        raise AssertionError(f"16-bit path: launches {launches}, want 1 packet, 1 lpc, "
                             "1 epilogue, 0 element")
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
    pw_err, l5, pk_plain16, lpc_plain_ms, _ = check_walk_lpc(cfg, words2, sizes2, w2, "packet")
    l_err = max(l_err, l5)
    e_args2, lpc_in2 = element_args(words2, sizes2), lanes(w2)
    el_kw = element_kw(cfg)
    p_args2, p_kw2 = packet_args(cfg, words2, sizes2)
    rows_st = 2 * walk_kernel.f_pad(F)  # rows a thread walks on a stereo batch
    t_pk16 = cuda_times(lambda: walk_kernel.dense_packet(*p_args2, **p_kw2))
    clk_pk16 = walk_clock(lambda: walk_kernel.dense_packet(*p_args2, **p_kw2), rows_st,
                          statistics.median(t_pk16))
    # The element kernel, off the decode path, on the same batch: its time
    # (phase 17 holds it against its plain version at this shape).
    t_el = cuda_times(lambda: walk_kernel.dense_element(*e_args2, **el_kw))
    clk_el = walk_clock(lambda: walk_kernel.dense_element(*e_args2, **el_kw), rows_st,
                        statistics.median(t_el))
    t_lpc = cuda_times(lambda: lpc_kernel.lpc_fir(*lpc_in2, F=F, taps=9), reps=LPC_REPS)
    t_lpc1 = cuda_times(lambda: lpc_kernel.lpc_fir(*lpc_in2, F=F, taps=9))
    clk_lpc = walk_clock(lambda: lpc_kernel.lpc_fir(*lpc_in2, F=F, taps=9), walk_kernel.f_pad(F),
                         statistics.median(t_lpc))
    print(
        f"phase 5 {tag} kernels vs plain at B={B2} (L={2 * B2}), tolerance 0: max_abs_err "
        f"packet {pw_err}, lpc {l_err}; packet ms {summary(t_pk16)} | plain {pk_plain16:.1f} | "
        f"{clk_pk16[0]:.1f} ns, {clk_pk16[1]:.0f} cycles a row at {clk_pk16[2]:.0f} MHz; "
        f"element (not on the path) ms {summary(t_el)} | {clk_el[0]:.1f} ns, "
        f"{clk_el[1]:.0f} cycles a row at {clk_el[2]:.0f} MHz; "
        f"lpc taps 9 ms {summary(t_lpc)} (one launch a sample: {summary(t_lpc1)}) | plain "
        f"{lpc_plain_ms:.1f} | {clk_lpc[0]:.1f} ns, "
        f"{clk_lpc[1]:.0f} cycles a row at {clk_lpc[2]:.0f} MHz; lpc taps 32 at "
        f"L={2 * B}, F={F3} ms {summary(t_l32)} | plain {plain_ms_32:.1f}"
    )

    def packet_bound(sizes, ns, channels):
        """Bound of the packet kernel's work on one batch: the packets' own
        bits, the lane inputs and every output once; a Rice decode per
        sample and channel."""
        Bp = sizes.numel()
        return bound(
            float(sizes.double().sum()) / 8 + 4 * Bp * (1 + 2 + channels * (14 + 32))
            + 4 * channels * walk_kernel.f_pad(F) * Bp,
            8 * channels * float(ns.double().sum()),
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
    pk16_bound = packet_bound(sizes2, w2.ns, 2)

    # ---- phase 6: every kernel against its plain version on hi-res batches (B=256) ----
    def hires_config(depth, channels, rate=96000, frame=F):
        return port.PacketConfig(
            frame_length=frame, bit_depth=depth, num_channels=channels, pb=40, mb=10, kb=14,
            max_run=255, max_frame_bytes=0, avg_bit_rate=0, sample_rate=rate,
        )

    def hires_inputs(c, packets):
        """The words, the walk and the raw reader's inputs as the decode path
        builds them (walk, then epilogue.shift_reads: every channel's lanes
        and the row map)."""
        words, sizes = TorchBatchDecoder(c, dev)._stage(packets)
        w = walk(c, words, sizes)
        return words, sizes, w, shift_reads(w.shift_base, w.bs, w.role, w.ns)

    # Packets of F6 samples: a plain element walk costs its op launches per
    # row whatever B is, and phases 5 and 8 hold the kernels at F=4096.
    F6 = 512
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
            a = raw_read(words, *args[:5], F=F6, signed=signed, row=args[5])
            b = raw_read_reference(words, *args[:5], F=F6, signed=signed, row=args[5])
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
    # One raw read for every channel (the pair's fused read on channel 0's
    # lanes; channel 1's lanes, which no pair reads for, inactive).
    if (h_launches["packet"], h_launches["lpc"], h_launches["raw_read"],
            h_launches["epilogue"], h_launches["element"]) != (1, 1, 1, 1, 0):
        raise AssertionError(f"hi-res path: launches {h_launches}, want 1 packet, 1 lpc, "
                             "1 raw read, 1 epilogue, 0 element")
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
    e8, l8, pk_plain_h, h_lpc_plain_ms, _ = check_walk_lpc(hcfg, hwords, hsizes, hw, "packet")
    pw_err, l_err = max(pw_err, e8), max(l_err, l8)
    def hread():
        return raw_read(hwords, *hargs[:5], F=F, row=hargs[5])

    want = raw_read_reference(hwords, *hargs[:5], F=F, row=hargs[5])
    r_err = max(r_err, amax((hread() - want).abs()))
    if r_err != 0:
        raise AssertionError(f"raw reader differs from its plain version at B={n_pk}: {r_err}")
    h_e_args, h_lpc_in = element_args(hwords, hsizes), lanes(hw)
    h_e_kw = element_kw(hcfg)
    h_p_args, h_p_kw = packet_args(hcfg, hwords, hsizes)
    t_pkh = cuda_times(lambda: walk_kernel.dense_packet(*h_p_args, **h_p_kw))
    clk_pkh = walk_clock(lambda: walk_kernel.dense_packet(*h_p_args, **h_p_kw), rows_st,
                         statistics.median(t_pkh))
    t_hel = cuda_times(lambda: walk_kernel.dense_element(*h_e_args, **h_e_kw))
    t_hlpc = cuda_times(lambda: lpc_kernel.lpc_fir(*h_lpc_in, F=F, taps=9), reps=LPC_REPS)
    clk_hlpc = walk_clock(lambda: lpc_kernel.lpc_fir(*h_lpc_in, F=F, taps=9),
                          walk_kernel.f_pad(F), statistics.median(t_hlpc))
    h_el_bound, h_lpc_bound = walk_bounds(hw, hsizes, h_lpc_in)
    pkh_bound = packet_bound(hsizes, hw.ns, 2)
    # The raw reader cold (L2 flushed by a 1 GiB write before each launch,
    # as after the walk and the LPC on the real path) and warm (20 launches
    # back to back over the same ~50 MB, about the size of L2).
    flush = torch.empty(1 << 28, dtype=i32, device=dev)

    def cold_read():
        flush.zero_()
        return timed(hread)[1]

    cold_read()
    t_rr = [cold_read() for _ in range(RUNS)]
    del flush
    t_rr_warm = cuda_times(hread, reps=20)
    t_rr_plain = cuda_times(lambda: raw_read_reference(hwords, *hargs[:5], F=F, row=hargs[5]))

    def raw_bound(args, out):
        """Bytes: each lane's fields (n rows of step bits) read once, its six
        inputs and the output plane once; operations: two shifts, an or
        and a shift a field."""
        step, act, n = args[1], args[3], args[4]
        fields = torch.where(act != 0, n, 0).double()
        return bound(float((fields * step.double()).sum()) / 8 + 4 * 6 * act.numel()
                     + 4 * out.numel(), 4 * float(fields.sum()))

    rr_bound = raw_bound(hargs, want)
    hreaders = int(hargs[3].view(2, -1).any(dim=1).sum())
    print(
        f"phase 8 {tag} kernels vs plain at B={n_pk} F={F} 24-bit stereo bytesShifted=1, "
        f"tolerance 0: max_abs_err packet {pw_err}, lpc {l_err}, raw reader {r_err}; "
        f"packet ms {summary(t_pkh)} | plain {pk_plain_h:.1f} | bound {pkh_bound[0]:.4f} by "
        f"{pkh_bound[1]} | {clk_pkh[0]:.1f} ns, {clk_pkh[1]:.0f} cycles a row at "
        f"{clk_pkh[2]:.0f} MHz; element (not on the path) ms {summary(t_hel)} | bound "
        f"{h_el_bound[0]:.4f} by {h_el_bound[1]}; lpc taps 9 ms {summary(t_hlpc)} | plain "
        f"{h_lpc_plain_ms:.1f} | bound {h_lpc_bound[0]:.4f} by {h_lpc_bound[1]} | "
        f"{clk_hlpc[1]:.0f} cycles a row at {clk_hlpc[2]:.0f} MHz; raw reader (one launch, "
        f"L={hargs[0].numel()} lanes of 2 channels, {hreaders} with active lanes; the pair as "
        f"one {int(hargs[1][0])}-bit field) ms cold {summary(t_rr)} | warm "
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
    # Rows of F11 samples: phase 13 holds both kernels at F=4096.
    F11 = 512

    def enc_lanes(cb, seed):
        """(x (256, F11) int32 on the card, ns (256,)): music, 20 lanes of
        full-scale noise at ``cb`` bits, 10 sparse lanes (long zero runs),
        an all-zero lane, an empty and a partial packet."""
        g = np.random.default_rng(seed)
        x = music_pcm(256 * F11, 1, seed, depth=min(cb - 1, 24))[:, 0].reshape(256, F11)
        x[200:220] = g.integers(-(1 << (cb - 1)), 1 << (cb - 1), size=(20, F11))
        sparse = g.random((10, F11)) < 0.002
        x[220:230] = np.where(sparse, g.integers(-40, 40, size=(10, F11)), 0)
        x[230] = 0
        ns = np.full(256, F11, np.int32)
        ns[231], ns[232] = 0, F11 // 3 + 1
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
        return got[: kw["F"]], ms, err

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

    LPC_LANE_AXES = (2, 0, 0, 0, 0, 0, 0, 0, 0)
    ENCODE_LANE_AXES = (1, 1, 0, 0, 0, 0, 0)

    def side_by_side(sets, lane_axes):
        """Several sets of a kernel's inputs as one, joined along each
        tensor's lane axis (every lane carries its own order, mode and
        widths)."""
        return tuple(torch.cat(ts, dim=ax) for ts, ax in zip(zip(*sets), lane_axes))

    def body_words(kb, cb):
        return (F11 * (9 + max(kb, cb) + 26) + 256) // 32 + 4

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
            args, got_taps = encode_device._lpc_forward_args(
                [x], order, 9, cb, ns11, [coefs], F11, mode)
            if got_taps != taps:
                raise AssertionError(f"order {order} runs at {got_taps} taps, not {taps}")
            sets.append((args, cb, ns11))
        args = side_by_side([sets[0][0], sets[1][0]], LPC_LANE_AXES)
        res, ms, err = lpc_forward_check(args, dict(F=F11, taps=taps, forward=True))
        fwd_err = max(fwd_err, err)
        for i, (_, cb, ns11) in enumerate(sets):
            res_by_cb.setdefault(cb, []).append((res[:, 256 * i : 256 * (i + 1)].T.contiguous(),
                                                 ns11))
        f_lines.append(
            f"taps {taps}: " + " and ".join(f"order {o} mode {m} cb {c}" for o, m, c in regimes)
            + f" (L=512, plain {ms:.0f} ms)"
        )
    pb_local = torch.full((256,), cfg.pb, dtype=i32, device=dev)

    def entropy_inputs(cb):
        res, ns11 = res_by_cb[cb][0]
        return encode_device._entropy_args(res, ns11, pb_local, cb, cfg.mb)

    e_lines = []
    for kb, cbs in ((14, (17, 32)), (28, (32,))):
        args = entropy_inputs(cbs[0])
        if len(cbs) == 2:
            args = side_by_side([args, entropy_inputs(cbs[1])], ENCODE_LANE_AXES)
        bits11, ovf11, ms, err = encode_check(
            args, dict(kb=kb, F=F11, W_out=body_words(kb, max(cbs))))
        enc_err = max(enc_err, err)
        for i, cb in enumerate(cbs):
            lane0 = 256 * i
            zero_runs = int((args[1][:, lane0 + 220 : lane0 + 231] > F11 // 16).sum())
            noise_bits = int(bits11[lane0 + 200 : lane0 + 220].min())
            if int(bits11[lane0 + 231]) != 0 or int(ovf11.sum()) != 0 or zero_runs == 0:
                raise AssertionError(f"phase 11 kb {kb} cb {cb}: empty lane, ovf or zero runs wrong")
            # At kb 14 a 32-bit noise value always escapes: a 9-one prefix and 32 raw bits.
            if (kb, cb) == (14, 32) and noise_bits < F11 * 41 * 9 // 10:
                raise AssertionError("phase 11 kb 14 cb 32: the noise lanes did not escape")
            e_lines.append(
                f"kb {kb} cb {cb}: {int(bits11[lane0 : lane0 + 256].sum()) // 8} bytes, noise "
                f"lanes {noise_bits}+ bits"
            )
        e_lines[-1] += f" (B={256 * len(cbs)}, plain {ms:.0f} ms)"
    # One launch for an element's two channels (orders 4 and 6, chan bits
    # 17) under pbFactor candidates 2, 4 and 7, as encode_walk makes it:
    # lanes candidate-major, each reading its channel's row by the row map.
    pair = [r for r, _ in res_by_cb[17][:2]]
    ns_pair = res_by_cb[17][0][1].to(i64)
    cand_pb = [torch.full((256,), (cfg.pb * p) // 4, dtype=i64, device=dev) for p in (2, 4, 7)]
    c_args, c_row = encode_device._element_entropy_args(pair, ns_pair, cand_pb, 17, cfg.mb)
    c_bits, c_ovf, c_ms, c_err = encode_check(
        c_args, dict(kb=14, F=F11, W_out=body_words(14, 17), row=c_row))
    enc_err = max(enc_err, c_err)
    per_cand = c_bits.view(3, 512).sum(dim=1)
    if int(c_ovf.sum()) != 0 or len(set(per_cand.tolist())) != 3:
        raise AssertionError(f"phase 11 candidates: ovf or equal sizes {per_cand.tolist()}")
    e_lines.append(
        f"pbFactor candidates 2, 4, 7 over two channels in one launch (L={c_row.numel()}, row "
        f"map): {[int(b) // 8 for b in per_cand]} bytes (plain {c_ms:.0f} ms)"
    )
    print(
        f"phase 11 forward lpc and encode kernels vs plain (256 lanes a regime, F={F11}, "
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
    # One CPE a packet: the forward LPC and the encode kernel run once each
    # for both channels.
    if (e_launches["lpc_forward"], e_launches["encode"]) != (1, 1):
        raise AssertionError(f"16-bit stereo encode: launches {e_launches}, want one forward "
                             "LPC and one encode for the element's two channels")
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
    prof_s, dev_us = profile_call(lambda: port.encode_packets_device(cfg, fit_spec, chunks16),
                                  torch.cuda.synchronize)
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
    # One more call of phase 12's, collecting what it hands encode_walk (a
    # replay of its program runs no Python), then one eager encode_walk on
    # those inputs collecting what it hands each kernel: every launch of the
    # call is held to its plain version.
    encode_device._calls = calls = []
    try:
        port.encode_packets_device(cfg, fit_spec, chunks16)
        (w_args, w_kw), = [(a, kw) for n, a, kw in calls if n == "encode_walk"]
        encode_device.encode_walk(*w_args, **w_kw)
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
    # The plain versions work lane by lane and cost their op launches per
    # row whatever the lane count: each runs once, over the lanes of all the
    # call's launches side by side, and is held against the outputs of the
    # kernel launched on each launch's own inputs.
    if any(kw != by["lpc_forward"][0][1] for _, kw in by["lpc_forward"]):
        raise AssertionError("the call's lpc_forward launches differ in their settings")
    f_kw = by["lpc_forward"][0][1]
    (e_args, e_kw), = by["encode"]  # phase 12 checked the call makes one
    got = torch.cat([lpc_kernel.lpc_fir(*a, **f_kw) for a, _ in by["lpc_forward"]], dim=1)
    f_all = side_by_side([a for a, _ in by["lpc_forward"]], LPC_LANE_AXES)
    want, fwd_plain_ms = timed(lambda: lpc_kernel.lpc_fir_reference(*f_all, **f_kw))
    err = amax((got.to(i64) - want.to(i64)).abs())
    if err != 0:
        raise AssertionError(f"forward LPC differs from its plain version on the call's "
                             f"launches: max {err}")
    fwd_err = max(fwd_err, err)
    del got, want, f_all
    t_fwd, t_fwd1, fwd_bounds = [], [], []
    for f_args, _ in by["lpc_forward"]:
        t_fwd += cuda_times(lambda: lpc_kernel.lpc_fir(*f_args, **f_kw), reps=LPC_REPS)
        t_fwd1 += cuda_times(lambda: lpc_kernel.lpc_fir(*f_args, **f_kw))
        rows, order13, ns_f, coefs13 = f_args[0], f_args[2], f_args[5], f_args[8]
        fwd_bounds.append(bound(
            4 * (2 * rows.numel() + 7 * order13.numel() + coefs13.numel()),  # rows in and out
            2 * float((order13.double() * ns_f.double()).sum()),  # MACs of the prediction
        ))
    got = encode_kernel.dense_encode(*e_args, **e_kw)
    want, enc_plain_ms = timed(lambda: encode_kernel.dense_encode_reference(*e_args, **e_kw))
    for name, a, b in zip(("words", "bits", "ovf"), got, want):
        err = amax((a.to(i64) - b.to(i64)).abs())
        if err != 0:
            raise AssertionError(f"encode kernel on the call's launch: {name} differs from "
                                 f"the plain version by up to {err}")
    if int(got[2].sum()) != 0:
        raise AssertionError(f"{int(got[2].sum())} lanes overflowed their row")
    body_bytes = int(got[1].sum()) // 8
    del got, want
    t_enc = cuda_times(lambda: encode_kernel.dense_encode(*e_args, **e_kw))
    clk_enc = walk_clock(lambda: encode_kernel.dense_encode(*e_args, **e_kw), F,
                         statistics.median(t_enc))
    lanes13 = e_args[5].numel()
    enc_bound = bound(
        # n_t in, the lane inputs and the row map, zero-tailed rows out.  The
        # kernel reads zr_t only where it codes a zero run (a mean below
        # 128, rare in music), and the plain version does not report how
        # often that is: those reads are left out, so the bound is low by at
        # most 4 bytes a zero run.
        4 * (e_args[0].numel() + 6 * lanes13 + lanes13 * e_kw["W_out"] + 2 * lanes13),
        16 * float(e_args[5].sum()),  # a Rice code: clz, quotient, shifts, mean update
    )
    fwd_bound = max(fwd_bounds)
    f_args0 = by["lpc_forward"][0][0]
    clk_fwd = walk_clock(lambda: lpc_kernel.lpc_fir(*f_args0, **f_kw), walk_kernel.f_pad(F),
                         statistics.median(t_fwd))
    print(
        f"phase 13 {tag} encode-side kernels vs plain on every launch of one "
        f"encode_packets_device call (B={n_pk}, F={F}; {n_calls['lpc_forward']} forward lpc, "
        f"{n_calls['encode']} encode), tolerance 0: max_abs_err forward lpc {fwd_err}, encode "
        f"{enc_err}, ovf 0; forward lpc taps {f_kw['taps']} ms {summary(t_fwd)} (one launch a "
        f"sample: {summary(t_fwd1)}) | plain "
        f"(one run over every launch's lanes) {fwd_plain_ms:.1f} | bound {fwd_bound[0]:.4f} by "
        f"{fwd_bound[1]} | {clk_fwd[1]:.0f} cycles a row at {clk_fwd[2]:.0f} MHz (L="
        f"{f_args0[1].numel()}); encode (L={lanes13}) ms {summary(t_enc)} | plain (one run) "
        f"{enc_plain_ms:.1f} | bound {enc_bound[0]:.4f} by {enc_bound[1]} | {clk_enc[0]:.1f} ns, "
        f"{clk_enc[1]:.0f} cycles a sample at {clk_enc[2]:.0f} MHz; bodies "
        f"{body_bytes} bytes in rows of {e_kw['W_out']} words"
    )
    # The device part of the call alone (planes already on the card to words
    # and bit counts on the card), eagerly and as its program's replay; the
    # rest of the call is host staging, the upload, the download and the
    # per-packet cut.
    n_ovf = int(encode_device.encode_walk(*w_args, **w_kw)[2].sum())
    if n_ovf:
        raise AssertionError(f"encode_walk: {n_ovf} lanes overflowed")
    t_walk = cuda_times(lambda: encode_device.encode_walk(*w_args, **w_kw), runs=3)
    enc_prog, enc_graph = encode_program_check(
        port, w_args, w_kw, dev, lambda: port.encode_packets_device(cfg, fit_spec, chunks16))
    t_replay = cuda_times(enc_graph.replay, runs=3)
    t_call = host_times(lambda: port.encode_packets_device(cfg, fit_spec, chunks16), runs=3)
    enc_prog.update(replay_ms=summary(t_replay), eager_ms=summary(t_walk),
                    call_s=summary(t_call))
    del enc_graph
    print(
        f"phase 13 {tag} encode_walk at B={n_pk} (the device part of encode_packets_device), "
        f"ovf 0: as a program ({enc_prog['key']}), the first call ran eagerly, the second "
        f"captured ({enc_prog['capture_ms']:.1f} ms, pool {enc_prog['pool_bytes']} bytes), the "
        f"third was one replay (launches {enc_prog['third_call_launches']}, no eager run); a "
        f"replay's words, bits and ovf == eager encode_walk's on the same static inputs, byte "
        f"for byte; kernels and copies one replay enqueues (its program run: fill, replay, "
        f"clones) against one eager encode_walk (torch.profiler): {enc_prog['enqueued']}; ms: "
        f"replay {summary(t_replay)}, eager {summary(t_walk)} (an earlier run on an H100 80GB "
        f"HBM3 at 700 W, eager only: 28.9 ms); encode_packets_device s {summary(t_call)} "
        f"(that run: 0.1204; phase 12's warm median "
        f"{enc_med:.4f})"
    )


    # ---- phase 14: the packet kernel against its plain version (B=256, F=512) ----
    F14 = 512

    def with_prefix(prefix_bits: str, packet: bytes) -> bytes:
        """``packet`` with elements written before it, re-aligned to bytes."""
        n = len(prefix_bits) + 8 * len(packet)
        pad = -n % 8
        val = ((int(prefix_bits, 2) << (8 * len(packet))) | int.from_bytes(packet, "big")) << pad
        return val.to_bytes((n + pad) // 8, "big")

    def bits(value, width):
        return format(value, f"0{width}b")

    # FIL (3 bytes), FIL with the escape count (15 + 2 - 1 = 16 bytes), DSE
    # of 2 bytes, DSE with the align flag, in front of the pair: 5 of the
    # stereo budget of 6 elements.
    skips = (
        bits(6, 3) + bits(3, 4) + bits(0x112233, 24)
        + bits(6, 3) + bits(15, 4) + bits(2, 8) + "01" * 64
        + bits(4, 3) + bits(0, 4) + "0" + bits(2, 8) + bits(0xAABB, 16)
    )
    skips += bits(4, 3) + bits(1, 4) + "1" + bits(1, 8)
    skips += "0" * (-len(skips) % 8) + bits(0xCC, 8)

    def element_ends(c, packets):
        """The bit length of each packet's first element, from the element
        kernel's parse and walk on the card."""
        words, sizes = TorchBatchDecoder(c, dev)._stage(packets)
        args = element_args(words, sizes, c.num_channels, c.frame_length)
        _, bp, err, meta = walk_kernel.dense_element(*args, **element_kw(c))
        if int(err[: len(packets)].abs().sum()):
            raise AssertionError("a fixture packet did not parse")
        end = torch.where(meta[walk_kernel.M_ESC] == 1, meta[walk_kernel.M_ESC_END], bp)
        return end[: len(packets)].tolist()

    p_err, p_lines, p_plain = 0, [], []
    for i, (depth, ch, bsf) in ((0, (24, 8, 1)), (3, (16, 2, 0))):
        pc = hires_config(depth, ch, rate=48000, frame=F14)
        music = music_pcm(232 * F14 + F14 // 3, ch, SEED + 60 + i, depth=depth)
        noise = music_pcm(20 * F14, ch, SEED + 64 + i, tonality=0.0, depth=depth)
        pk = native.encode_packets(pc, music, bytes_shifted=bsf)  # ends in a partial packet
        pk += native.encode_packets(pc, noise, bytes_shifted=bsf)  # escapes
        if ch == 2:
            # SCE+SCE stereo: the first element of one mono packet, then
            # another mono packet whole; and skip elements before a pair.
            mc = hires_config(depth, 1, rate=48000, frame=F14)
            mono = native.encode_packets(mc, music[: 32 * F14, :1])
            ends = element_ends(mc, mono)
            for a in range(0, 32, 2):
                head = bits(int.from_bytes(mono[a], "big") >> (8 * len(mono[a]) - ends[a]), ends[a])
                pk.append(with_prefix(head, mono[a + 1]))
            pk += [with_prefix(skips, p) for p in pk[:16]]
            pk += [with_prefix((bits(6, 3) + bits(0, 4)) * 8, pk[0])]  # past the slot budget
        bad = bytearray(pk[4])
        for j in range(1, 40, 3):
            bad[j] ^= 1 << int(rng.integers(0, 8))
        late = bytearray(pk[5])
        for j in range(len(late) // 2, len(late) // 2 + 40, 3):
            late[j] ^= 1 << int(rng.integers(0, 8))
        pk += [pk[3][: len(pk[3]) // 3], bytes(bad), bytes(late)]
        pk = pk[-256:] if ch == 2 else pk[:253] + pk[-3:]
        assert len(pk) == 256
        words, sizes = TorchBatchDecoder(pc, dev)._stage(pk)
        p_args, p_kw = packet_args(pc, words, sizes)
        got = walk_kernel.dense_packet(*p_args, **p_kw)
        want, ms = timed(lambda: walk_kernel.dense_packet_reference(*p_args, **p_kw))
        p_err = max(p_err, packet_diff(got, want))
        p_plain.append(ms)
        if p_err != 0:
            names = ("rows", "err", "ns", "meta", "coefs")
            where = [n for n, a, b in zip(names, got, want) if not torch.equal(a, b)]
            raise AssertionError(f"{depth}-bit C={ch}: packet kernel differs from its plain "
                                 f"version in {where}")
        err14 = want[1]
        n_ok, n_bad = int((err14 == 0).sum()), int((err14 != 0).sum())
        filled = want[3][walk_kernel.PACKET_FIELDS.index("filled")]
        esc = want[3][walk_kernel.PACKET_FIELDS.index("esc")]
        if n_ok < 230 or n_bad < 2 or not (esc == 1).any() or int(filled[err14 == 0].min()) != 1:
            raise AssertionError(f"{depth}-bit C={ch}: {n_ok} clean lanes, {n_bad} error lanes, "
                                 "or no escapes, or a clean lane with an unfilled channel")
        if ch == 2:
            role = want[3][walk_kernel.PACKET_FIELDS.index("role")]
            n_ss = int(((role == 0).all(1) & (err14 == 0)).sum())
            n_slots = int((err14 == walk_kernel.ERR_SLOTS).sum())
            if n_ss < 16 or n_slots < 1:
                raise AssertionError(f"stereo batch: {n_ss} SCE+SCE lanes, {n_slots} ERR_SLOTS")
        p_lines.append(f"{depth}-bit C={ch} bs={bsf}: {n_ok} clean and {n_bad} error lanes equal "
                       f"(plain {ms / 1e3:.1f} s)")
    print(
        f"phase 14 packet kernel vs plain (B=256, F={F14}, tolerance 0, every output on every "
        f"lane): max_abs_err {p_err}; {'; '.join(p_lines)}; the stereo batch holds 16 SCE+SCE "
        f"packets, 16 with FIL/DSE elements before the pair and one past the slot budget"
    )

    # ---- phase 15: the multi-slot decode path at full width (7.1 surround) ----
    scfg = hires_config(24, 8, rate=48000)
    spcm = music_pcm(total, 8, SEED + 70, depth=24)
    t0 = time.perf_counter()
    spkts = native.encode_packets(scfg, spcm, bytes_shifted=1)
    enc_s = time.perf_counter() - t0
    assert len(spkts) == n_pk
    sdec = port.BatchDecoder(scfg)  # the default device: the card
    port.reset_launch_counts()
    sout = sdec.decode_packets(spkts)
    s_launches = port.launch_counts()
    check_decode(sout, spcm, 24)
    if (s_launches["packet"], s_launches["lpc"], s_launches["raw_read"],
            s_launches["epilogue"]) != (1, 1, 1, 1):
        raise AssertionError(f"7.1 path: launches {s_launches}, want 1 packet, 1 lpc, 1 raw "
                             "read, 1 epilogue")
    if sdec.impl.last_fallbacks:
        raise AssertionError(f"{sdec.impl.last_fallbacks} clean 7.1 packets fell back")
    s_audio_s = total / scfg.sample_rate
    print(
        f"phase 15 decode_packets B={n_pk} F={F} 48 kHz 24-bit 7.1 (SCE CPE CPE CPE SCE) "
        f"bytesShifted=1 ({s_audio_s:.1f} s of audio, {sum(map(len, spkts))} packet bytes, "
        f"{sum(map(len, sout))} PCM bytes): bytes == source PCM; launches {s_launches}; host "
        f"fallbacks {sdec.impl.last_fallbacks}; encode {enc_s:.2f} s"
    )
    del sout
    s_host = host_times(lambda: sdec.decode_packets(spkts))
    s_med = statistics.median(s_host)
    print(
        f"phase 15 {tag} decode_packets 7.1 B={n_pk}: s {summary(s_host)}; x realtime median "
        f"{s_audio_s / s_med:.1f} (min {s_audio_s / max(s_host):.1f}, max "
        f"{s_audio_s / min(s_host):.1f})"
    )
    # One profiled call (the second under the profiler; its device events).
    prof_s, dev_us = profile_call(lambda: sdec.decode_packets(spkts), torch.cuda.synchronize)
    busy_ms = sum(us for us, _, _ in dev_us) / 1e3
    top = "; ".join(f"{key[:40]} {us / 1e3:.2f} ms x{n}" for us, n, key in dev_us[:7])
    seen = any("packet_kernel" in key for _, _, key in dev_us)
    print(
        f"phase 15 {tag} one profiled 7.1 decode_packets call ({prof_s * 1e3:.0f} ms under the "
        f"profiler): device busy "
        + (f"{busy_ms:.1f} ms ({100 * busy_ms / (prof_s * 1e3):.1f}% of the call) in "
           f"{sum(n for _, n, _ in dev_us)} kernels and copies; top: {top}"
           if seen else "not measured (the profiler's records of the call lack the packet kernel)")
    )

    # One call's host stages, read from the port's spans: where the host
    # holds the card back.
    with stage_timer() as st:
        s_out = sdec.decode_packets(spkts)
    check_decode(s_out, spcm, 24)
    del s_out
    print(f"phase 15 {tag} one 7.1 call's host stages (the port's spans, ms): "
          + "; ".join(f"{k} {v:.1f}" for k, v in st.ms().items()))

    # ---- phase 16: the 7.1 path's kernels at its shapes ----
    swords, ssizes = sdec.impl._stage(spkts)
    sw = walk(scfg, swords, ssizes)
    s_lpc_in = lanes(sw, 8)
    p_args, p_kw = packet_args(scfg, swords, ssizes)
    got = walk_kernel.dense_packet(*p_args, **p_kw)
    # The plain version on the same batch, on the host: five elements a
    # packet, eight passes of F rows of op launches (234.8 s on the card in
    # an earlier run on an H100 80GB HBM3 at 700 W).
    want_p, pk_plain_ms = on_host(walk_kernel.dense_packet_reference, *p_args, **p_kw)
    pk_err = packet_diff(got, want_p)
    if pk_err != 0:
        names = ("rows", "err", "ns", "meta", "coefs")
        where = [n for n, a, b in zip(names, got, want_p) if not torch.equal(a, b)]
        raise AssertionError(f"packet kernel differs from its plain version at B={n_pk} "
                             f"F={F} in {where}")
    del got, want_p
    t_pk = cuda_times(lambda: walk_kernel.dense_packet(*p_args, **p_kw))
    clk_pk = walk_clock(lambda: walk_kernel.dense_packet(*p_args, **p_kw),
                        8 * walk_kernel.f_pad(F), statistics.median(t_pk))
    pk_bound = packet_bound(ssizes, sw.ns, 8)
    want_l, s_lpc_plain = timed(lambda: lpc_kernel.lpc_fir_reference(*s_lpc_in, F=F, taps=9))
    s_l_err = lpc_diff(lpc_kernel.lpc_fir(*s_lpc_in, F=F, taps=9), want_l, sw.ns.repeat(8))
    del want_l
    if s_l_err != 0:
        raise AssertionError(f"LPC kernel differs from its plain version at L={8 * n_pk}")
    l_err = max(l_err, s_l_err)
    t_slpc = cuda_times(lambda: lpc_kernel.lpc_fir(*s_lpc_in, F=F, taps=9), reps=LPC_REPS)
    clk_slpc = walk_clock(lambda: lpc_kernel.lpc_fir(*s_lpc_in, F=F, taps=9),
                          walk_kernel.f_pad(F), statistics.median(t_slpc))
    order16, fir16 = s_lpc_in[2], s_lpc_in[1]
    L16 = order16.numel()
    s_lpc_bound = bound(
        4 * (s_lpc_in[0].numel() + L16 * (7 + 9) + walk_kernel.f_pad(F) * L16),
        2 * float((s_lpc_in[5].double() * order16.double() * (fir16 == 1)).sum()),
    )
    sreads = shift_reads(sw.shift_base, sw.bs, sw.role, sw.ns)
    n_readers = int(sreads[3].view(8, -1).any(dim=1).sum())

    def sread():
        return raw_read(swords, *sreads[:5], F=F, row=sreads[5])

    want_r = raw_read_reference(swords, *sreads[:5], F=F, row=sreads[5])
    s_r_err = amax((sread() - want_r).abs())
    if s_r_err != 0:
        raise AssertionError(f"raw reader differs from its plain version on the 7.1 batch")
    r_err = max(r_err, s_r_err)
    t_srr = cuda_times(sread)
    s_rr_bound = raw_bound(sreads, want_r)
    del want_r
    print(
        f"phase 16 {tag} the 7.1 path's kernels at B={n_pk} F={F}, tolerance 0: packet kernel "
        f"vs plain max_abs_err {pk_err} (plain on the host {pk_plain_ms / 1e3:.1f} s); lpc "
        f"(L={L16}) vs plain "
        f"{s_l_err}; raw reads vs plain {s_r_err}; packet ms {summary(t_pk)} | bound "
        f"{pk_bound[0]:.4f} by {pk_bound[1]} | {clk_pk[0]:.1f} ns, {clk_pk[1]:.0f} cycles a row "
        f"at {clk_pk[2]:.0f} MHz; lpc taps 9 ms "
        f"{summary(t_slpc)} | plain {s_lpc_plain:.1f} | bound {s_lpc_bound[0]:.4f} by "
        f"{s_lpc_bound[1]} | {clk_slpc[1]:.0f} cycles a row at {clk_slpc[2]:.0f} MHz; the raw "
        f"read (one launch, L={sreads[0].numel()} lanes of 8 channels, {n_readers} with active "
        f"lanes) ms {summary(t_srr)} "
        f"| bound {s_rr_bound[0]:.4f} by {s_rr_bound[1]}"
    )
    del swords, sw, s_lpc_in, sreads

    # ---- phase 17: the dense entropy kernel on its probe path ----
    def entropy_streams(res_list, ns_l, pb_list, cb_l, kb, start, Fe):
        """Pure-entropy streams, no framing: each lane's residual rows
        (B, Fe) encoded by the encode kernel, one body after the other from
        bit ``start`` of the lane's row: (words, bits of each body)."""
        Bs = ns_l.numel()
        Wch = (Fe * (9 + max(kb, 32) + 26) + 256) // 32 + 4
        words = torch.zeros((Bs, len(res_list) * Wch + 16), dtype=i32, device=dev)
        at, counts = start.to(i64), []
        for res, pb_l in zip(res_list, pb_list):
            # The zigzagged rows and the zero-run table as the encode path
            # builds them; the suffix width is each lane's own here.
            n_t, zr_t, on, pb_i32, _, ns_i32, mb_l = encode_device._entropy_args(
                res, ns_l, pb_l, 0, cfg.mb)
            body, nbits, ovf = encode_kernel.dense_encode(
                n_t, zr_t, on, pb_i32, cb_l, ns_i32, mb_l, kb=kb, F=Fe, W_out=Wch)
            if int(ovf.sum()):
                raise AssertionError("probe stream overflowed its row")
            encode_device._blit_bits(words, at, body)
            at = at + nbits
            counts.append(nbits.to(i64))
        return words, counts

    def entropy_diff(got, want):
        return max(amax((a.to(i64) - b.to(i64)).abs()) for a, b in zip(got, want))

    B17, F17 = 256, 512
    g17 = np.random.default_rng(SEED + 80)
    lane17 = torch.arange(B17, device=dev)
    cb17 = torch.where(lane17 % 2 == 0, 17, 32).to(i32)

    def residuals17(seed):
        """Small values, dense and sparse zero runs, all-zero lanes, escape
        codewords and full-scale values at each lane's suffix width."""
        g = np.random.default_rng(seed)
        r = g.integers(-60, 60, (B17, F17))
        r[32:64] = np.where(g.random((32, F17)) < 0.7, 0, r[32:64])
        r[64:80] = np.where(g.random((16, F17)) < 0.003, r[64:80], 0)
        r[80:84] = 0
        r[96:128] = g.integers(-(1 << 15), 1 << 15, (32, F17))
        r[128:160:2] = g.integers(-(1 << 16) + 1, 1 << 16, (16, F17))
        r[129:160:2] = g.integers(-(1 << 31) + 1, 1 << 31, (16, F17))
        return torch.from_numpy(r.astype(np.int32)).to(dev)

    ns17 = torch.full((B17,), F17, dtype=i32, device=dev)
    ns17[[5, 170]] = 0
    ns17[[7, 171]] = torch.tensor([F17 // 3, 1], dtype=i32, device=dev)
    one17 = torch.ones(B17, dtype=i32, device=dev)
    act17, act2_17 = one17.clone(), one17.clone()
    act17[[9, 200]] = 0
    act2_17[[11, 200]] = 0
    de_err, de_plain = 0, []
    for passes, kb17, pbs in ((2, 14, (40, 24)), (1, 6, (40,))):
        start = torch.from_numpy(g17.integers(0, 300, B17)).to(dev)
        pb_l = [one17 * pb for pb in pbs]
        res17 = [residuals17(SEED + 81 + p) for p in range(passes)]
        words17, counts = entropy_streams(res17, ns17, pb_l, cb17, kb17, start, F17)
        size17 = start + sum(counts)
        size17 = torch.where(lane17 % 8 == 3, start + counts[0] // 2, size17)  # truncated
        args17 = (words17, start.to(i32), act17, pb_l[0], cb17, ns17, size17.to(i32),
                  one17 * cfg.mb, act2_17, pb_l[-1])
        kw17 = dict(kb=kb17, F=F17, passes=passes)
        got = walk_kernel.dense_entropy(*args17, **kw17)
        want, ms = timed(lambda: walk_kernel.dense_entropy_reference(*args17, **kw17))
        de_err = max(de_err, entropy_diff(got, want))
        de_plain.append(ms)
        rows17, bp17, err17 = got
        n_over = int((err17 == walk_kernel.ERR_OVERRUN).sum())
        clean = (err17 == 0) & (act17 == 1) & (lane17 % 8 != 3)
        t17 = torch.arange(F17, device=dev)[None, :] < ns17[:, None]
        back = all(
            torch.equal((rows17[p, :F17].T * t17)[live], (res17[p] * t17)[live])
            for p, live in enumerate((clean, clean & (act2_17 == 1))[:passes])
        )
        end17 = start + counts[0] + (counts[1] * (act2_17 == 1) if passes == 2 else 0)
        cursors = torch.equal(bp17[clean].to(i64), end17[clean])
        if de_err != 0 or n_over < 16 or not back or not cursors:
            raise AssertionError(
                f"dense entropy kernel, passes {passes} kb {kb17}: max_abs_err {de_err} against "
                f"its plain version, {n_over} truncated lanes flagged, round trip {back}"
            )
    # At full size: the residual rows of phase 5's batch, encoded by the
    # encode kernel, one body per channel.
    t_full = torch.arange(F, device=dev)[None, :] < w2.ns[:, None]
    res_uv = [(w2.res[p, :F].T * t_full).contiguous() for p in range(2)]
    pb2048 = torch.full((B2,), cfg.pb, dtype=i32, device=dev)
    zero2048 = torch.zeros(B2, dtype=i64, device=dev)
    words_e, counts_e = entropy_streams(
        res_uv, w2.ns, [pb2048, pb2048], torch.full_like(w2.ns, 17), cfg.kb, zero2048, F)
    one2048 = torch.ones(B2, dtype=i32, device=dev)
    args_e = (words_e, torch.zeros_like(w2.ns), one2048, pb2048, one2048 * 17, w2.ns,
              (counts_e[0] + counts_e[1]).to(i32), one2048 * cfg.mb, one2048, pb2048)
    port.reset_launch_counts()
    rows_e, bp_e, err_e = port.dense_entropy(*args_e, kb=cfg.kb, F=F, passes=2)
    de_launches = port.launch_counts()["dense_entropy"]
    round_trip = max(
        amax((rows_e[p, :F].T.to(i64) - res_uv[p].to(i64)).abs()) for p in range(2))
    cursor = amax((bp_e.to(i64) - counts_e[0] - counts_e[1]).abs())
    if round_trip or cursor or int(err_e.abs().sum()) or de_launches != 1:
        raise AssertionError(
            f"dense entropy at B={B2}: rows differ from what was encoded by {round_trip}, the "
            f"cursor from the encoder's bit count by {cursor}, {int((err_e != 0).sum())} error "
            f"lanes, {de_launches} launches"
        )
    want_e, de_plain_full = timed(lambda: walk_kernel.dense_entropy_reference(
        *args_e, kb=cfg.kb, F=F, passes=2))
    de_full = entropy_diff((rows_e, bp_e, err_e), want_e)
    if de_full != 0:
        raise AssertionError(f"dense entropy kernel differs from its plain version at B={B2} "
                             f"F={F}: {de_full}")
    del want_e
    de_err = max(de_err, round_trip, cursor, de_full)
    t_de = cuda_times(lambda: walk_kernel.dense_entropy(*args_e, kb=cfg.kb, F=F, passes=2))
    clk_de = walk_clock(lambda: walk_kernel.dense_entropy(*args_e, kb=cfg.kb, F=F, passes=2),
                        rows_st, statistics.median(t_de))
    de_bound = bound(
        float((counts_e[0] + counts_e[1]).sum()) / 8 + 4 * B2 * 9
        + 4 * 2 * walk_kernel.f_pad(F) * B2 + 4 * 2 * B2,
        8 * 2 * float(w2.ns.double().sum()),
    )
    # On the packets themselves: the element kernel's parse gives the start
    # cursors (16-bit, no shift region: the entropy data starts where the
    # predictor headers end) and the two pbFactor fields are read here.  This
    # probe is the element kernel's path since the decode path left it: its
    # launches are counted from here to the walk below.
    port.reset_launch_counts()
    rows_k, bp_k, err_k, meta_k = walk_kernel.dense_element(*e_args2, **el_kw)
    from saprobe_alac_tpu_torch.ops.streambits import vread

    partial16 = vread(words2, torch.full((B2,), 19, device=dev), 4) >> 3
    hdr_u = 23 + 32 * partial16 + 16
    pbf_u = vread(words2, hdr_u + 8, 3)
    pbf_v = vread(words2, hdr_u + 16 + 16 * meta_k[walk_kernel.M_NUM_U].to(i64) + 8, 3)
    comp16 = ((meta_k[walk_kernel.M_COMP] == 1) & (meta_k[walk_kernel.M_CPE] == 1)
              & (err_k == 0)).to(i32)
    args_p = (words2, meta_k[walk_kernel.M_SHIFT_BASE].contiguous(), comp16,
              ((cfg.pb * pbf_u) >> 2).to(i32), one2048 * 17, meta_k[walk_kernel.M_NS].contiguous(),
              sizes2, one2048 * cfg.mb, comp16, ((cfg.pb * pbf_v) >> 2).to(i32))
    rows_p, bp_p, err_p = walk_kernel.dense_entropy(*args_p, kb=cfg.kb, F=F, passes=2)
    probe_launches = port.launch_counts()
    if (probe_launches["element"], probe_launches["dense_entropy"]) != (1, 1):
        raise AssertionError(f"probe on phase 4's packets: launches {probe_launches}")
    on = comp16 == 1
    vs_element = max(
        amax((rows_p - rows_k).abs()[:, :, on]), amax((bp_p - bp_k).abs()[on]),
        amax(err_p.abs()[on]))
    if vs_element != 0 or int(on.sum()) < B2 - 8:
        raise AssertionError(f"dense entropy on phase 4's packets differs from the element "
                             f"kernel by {vs_element} ({int(on.sum())} compressed pair lanes)")
    de_err = max(de_err, vs_element)
    # The element kernel's launch here against its plain version on the same
    # inputs (a fault in the shared walk loop would show on both sides of
    # the comparison above).
    want_k, el_plain_full = timed(lambda: walk_kernel.dense_element_reference(*e_args2, **el_kw))
    el_full = element_diff((rows_k, bp_k, err_k, meta_k), want_k, walk_kernel.M_NS)
    del want_k
    if el_full != 0:
        raise AssertionError(f"element kernel differs from its plain version at B={B2} F={F}: "
                             f"{el_full}")
    e_err = max(e_err, el_full)
    print(
        f"phase 17 {tag} dense entropy kernel, tolerance 0: vs plain at B={B17} F={F17} (2 "
        f"passes kb 14, 1 pass kb 6; suffix widths 17 and 32, start cursors, truncated, empty, "
        f"partial and inactive lanes) max_abs_err {de_err}, plain ms {de_plain}; at B={B2} "
        f"F={F}, 2 passes, streams from the encode kernel ({int(sum(counts_e).sum()) // 8} "
        f"bytes): every output == the plain version's (plain {de_plain_full / 1e3:.1f} s), "
        f"rows == the residuals encoded, cursor == the encoder's bits, {de_launches} "
        f"launch; on phase 4's packets from the element kernel's start cursors: rows and "
        f"cursors == the element kernel's on {int(on.sum())} lanes ({probe_launches['element']} "
        f"element launch; its rows, cursors, errors and metadata == its plain version's, plain "
        f"{el_plain_full / 1e3:.1f} s); ms {summary(t_de)} | bound {de_bound[0]:.4f} by "
        f"{de_bound[1]} | {clk_de[0]:.1f} ns, {clk_de[1]:.0f} cycles a row at {clk_de[2]:.0f} MHz"
    )

    # ---- phase 18: the LPC kernel's other bodies at full size ----
    # Phases 5, 8 and 16 hold the order-4 body (the music is order 4
    # throughout), phase 13 the forward order-6 body.  Here phase 4's PCM
    # encoded at orders 4 and 8 in turn ("mix48": each warp runs both
    # bodies), at orders 4 and 7 in turn ("general": the order-7 lanes run
    # the general 9-tap loop), and at order 12 with every fourth packet order
    # 31, mode 1 ("taps32": the 32-tap variant, as the decode path's retry
    # runs it); then the forward direction on the "general" and "taps32"
    # lanes, their decoded rows as the signal.
    pk_o = {o: native.encode_packets(cfg, pcm, order=o) for o in (7, 8, 12)}
    pk31 = native.encode_packets(cfg, pcm, order=31, mode=1)
    g_lines, g_res, f_res, fwd_in = [], {}, {}, {}

    def lpc_case(label, lin_g, ns_g, taps, fwd):
        want_g, plain_g = timed(
            lambda: lpc_kernel.lpc_fir_reference(*lin_g, F=F, taps=taps, forward=fwd))
        err_g = lpc_diff(lpc_kernel.lpc_fir(*lin_g, F=F, taps=taps, forward=fwd), want_g, ns_g)
        if err_g != 0:
            raise AssertionError(f"LPC kernel ({label}, {taps} taps) differs from its plain "
                                 f"version at B={n_pk} F={F}: {err_g}")
        t_g = cuda_times(lambda: lpc_kernel.lpc_fir(*lin_g, F=F, taps=taps, forward=fwd),
                         reps=LPC_REPS)
        clk_g = walk_clock(lambda: lpc_kernel.lpc_fir(*lin_g, F=F, taps=taps, forward=fwd),
                           walk_kernel.f_pad(F), statistics.median(t_g))
        Lg = lin_g[2].numel()
        b_g = bound(
            4 * (lin_g[0].numel() + Lg * (7 + taps) + walk_kernel.f_pad(F) * Lg),
            2 * float((lin_g[5].double() * lin_g[2].double() * (lin_g[1] == 1)).sum()),  # MACs
        )
        (f_res if fwd else g_res)[label] = (statistics.median(t_g), plain_g, b_g, clk_g[1])
        orders = sorted(set(lin_g[2].tolist()))
        g_lines.append(
            f"{label} ({'forward, ' if fwd else ''}{taps} taps, orders {orders}, L={Lg}): "
            f"max_abs_err {err_g}; ms {summary(t_g)} | plain {plain_g:.1f} | bound "
            f"{b_g[0]:.4f} by {b_g[1]} | {clk_g[1]:.0f} cycles a row at {clk_g[2]:.0f} MHz"
        )
        return err_g, want_g

    for label, packets, taps in (
        ("mix48", [pkts[i] if i % 2 == 0 else pk_o[8][i] for i in range(n_pk)], 9),
        ("general", [pkts[i] if i % 2 == 0 else pk_o[7][i] for i in range(n_pk)], 9),
        ("taps32", [pk31[i] if i % 4 == 3 else pk_o[12][i] for i in range(n_pk)], 32),
    ):
        words_g, sizes_g = stager._stage(packets)
        w_g = walk(cfg, words_g, sizes_g)
        lin_g, ns_g = lanes(w_g), w_g.ns.repeat(C)
        order_g = lin_g[2].view(-1, 32)  # the lanes of each warp
        if label == "mix48" and not bool((order_g != order_g[:, :1]).any(dim=1).all()):
            raise AssertionError("phase 18: a warp holds one order")
        if label == "general" and int((lin_g[2] == 7).sum()) < lin_g[2].numel() // 4:
            raise AssertionError("phase 18: under a quarter of the lanes at order 7")
        err_g, want_g = lpc_case(label, lin_g, ns_g, taps, False)
        l_err = max(l_err, err_g)
        if label != "mix48":
            fwd_in[label] = ((want_g[None].contiguous(), *lin_g[1:]), ns_g, taps)
        del want_g
    for label, (lin_f, ns_f, taps) in fwd_in.items():
        err_f, _ = lpc_case(f"forward_{label}", lin_f, ns_f, taps, True)
        fwd_err = max(fwd_err, err_f)
    print(f"phase 18 {tag} lpc kernel, its other bodies vs plain at B={n_pk} F={F}, tolerance 0: "
          + "; ".join(g_lines))
    del pk_o, pk31, fwd_in

    # ---- phase 19: one BatchDecoder on the card shared by four threads ----
    cfg128 = dataclasses.replace(cfg, frame_length=128)
    pcm128 = music_pcm(128 * 17 + 41, C, 8)
    pk128 = native.encode_packets(cfg128, pcm128)
    n_small = shared_decoder(port, cfg128, pk128, pcm128, 5, 2000)
    n_big = shared_decoder(port, cfg, pkts, pcm, 3, 3000)
    print(f"phase 19 one BatchDecoder(cfg) on the card, four threads at once: F=128 (18 "
          f"packets, five slices a thread, {n_small} packets decoded) and B={n_pk} F={F} "
          f"(phase 4's packets, three slices a thread, {n_big} packets decoded): every slice's "
          f"bytes == source PCM, host fallbacks 0")

    # ---- phase 20: the facade, the CLI and the corpus service at full size ----
    t20 = time.perf_counter()
    res20, l20 = facade_phase(port, tag, dev)
    res20["phase_s"] = time.perf_counter() - t20
    print(f"phase 20 {tag} numbers: {json.dumps(res20)}")

    # ---- phase 21: the ragged batch, sharding, the profiler, features, host backends ----
    t21 = time.perf_counter()
    main_batches = {"16-bit stereo": (cfg, pkts, pcm), "96 kHz 24-bit stereo": (hcfg, hpkts, hpcm),
                    "7.1": (scfg, spkts, spcm)}
    res21, l21 = new_paths_phase(port, tag, dev, main_batches, ragged3)
    res21["phase_s"] = time.perf_counter() - t21
    print(f"phase 21 {tag} numbers: {json.dumps(res21)}")

    # ---- phase 22: the decode programs, replay against eager ----
    t22 = time.perf_counter()
    res22 = programs_phase(port, tag, dev, main_batches, ragged3)
    res22["phase_s"] = time.perf_counter() - t22
    print(f"phase 22 {tag} numbers: {json.dumps(res22)}")

    # ---- phase 23: a corpus of many configs, the program cache's budget ----
    t23 = time.perf_counter()
    res23, l23 = corpus_configs_phase(port, tag, dev)
    res23["phase_s"] = time.perf_counter() - t23
    print(f"phase 23 {tag} numbers: {json.dumps(res23)}")

    # ---- phase 24: the epilogue kernel against its plain twin ----
    t24 = time.perf_counter()
    res24 = epilogue_phase(tag, dev, {"7.1": (scfg, spkts), "16-bit stereo": (cfg, pkts),
                                      "96 kHz 24-bit stereo B=256": (hcfg, hpkts[:256])})
    print(f"phase 24 {tag} seconds: {time.perf_counter() - t24:.1f}")

    def phase21(kernel):
        """A kernel's launches on each of phase 21's paths, as JSON keys."""
        return {f"launches_phase21_{path}": counts[kernel] for path, counts in l21.items()
                if counts[kernel]}

    def case_fields(res_by_label):
        """Phase 18's times of the LPC's other bodies, as JSON keys."""
        return {f"{key}_{label}_F{F}": val for label, res in res_by_label.items()
                for key, val in zip(("ms", "plain_ms", "bound_ms", "cycles_per_row"),
                                    (res[0], res[1], res[2][0], res[3]))}

    kernels = [
        {
            "name": "element", "route": "cuda",
            "source": "saprobe_alac_tpu_torch/csrc/element_kernel.cu",
            "replaces": "saprobe_alac_tpu/ops/walk_kernel.py:747",
            # Off the decode path: its launches on phase 17's probe
            # (the parse that gives dense_entropy its cursors), held against
            # its plain version there; its time on that batch (phase 5).
            "launches": probe_launches["element"], "launches_on": "phase 17 probe",
            "max_abs_err": e_err,
            "ms": statistics.median(t_el), "plain_ms": el_plain_full,
            f"plain_ms_B256_F{F3}": el_plain_256,
            "bound_ms": el_bound[0], "bound_by": el_bound[1], "library_ms": None,
            "ms_hires": statistics.median(t_hel), "bound_ms_hires": h_el_bound[0],
            "ns_per_row": clk_el[0], "cycles_per_row": clk_el[1], "sm_mhz": clk_el[2],
            "ptxas": walk_regs.get("element_kernel"),
        },
        {
            "name": "lpc", "route": "cuda",
            "source": "saprobe_alac_tpu_torch/csrc/lpc_kernel.cu",
            "replaces": "saprobe_alac_tpu/ops/lpc_kernel.py:91",
            "launches": launches["lpc"], "max_abs_err": l_err,
            "launches_phase20_track": l20["track"]["lpc"],
            "launches_phase20_corpus": l20["corpus"]["lpc"],
            **phase21("lpc"), "launches_phase23_corpus": l23["lpc"],
            "plain_ms_phase20_window64": res20["plain_ms_window64"]["lpc"],
            "ms": statistics.median(t_lpc), "ms_one": statistics.median(t_lpc1),
            "plain_ms": lpc_plain_ms,
            "bound_ms": lpc_bound[0], "bound_by": lpc_bound[1], "library_ms": None,
            "cycles_per_row": clk_lpc[1], "sm_mhz": clk_lpc[2],
            "ptxas": {k: v for k, v in lpc_regs.items() if "dec" in k},
            "sass_loops": lpc_sass and {k: v for k, v in lpc_sass.items() if "dec" in k},
            "cycles_per_row_hires": clk_hlpc[1], "cycles_per_row_L16384": clk_slpc[1],
            **case_fields(g_res),
            f"ms_taps32_L512_F{F3}": statistics.median(t_l32),
            f"plain_ms_taps32_L512_F{F3}": plain_ms_32,
            "ms_hires": statistics.median(t_hlpc), "plain_ms_hires": h_lpc_plain_ms,
            "bound_ms_hires": h_lpc_bound[0],
        },
        {
            "name": "raw_read", "route": "cuda",
            "source": "saprobe_alac_tpu_torch/csrc/raw_reader_kernel.cu",
            "replaces": "saprobe_alac_tpu/ops/walk_kernel.py:1252",
            "launches": h_launches["raw_read"], "max_abs_err": r_err,
            "launches_phase20_corpus": l20["corpus"]["raw_read"],
            **phase21("raw_read"), "launches_phase23_corpus": l23["raw_read"],
            "plain_ms_phase20_corpus_hires": res20["plain_ms_raw_read_corpus"]["hires"],
            "plain_ms_phase20_corpus_71": res20["plain_ms_raw_read_corpus"]["7.1"],
            "ms": statistics.median(t_rr), "plain_ms": statistics.median(t_rr_plain),
            "bound_ms": rr_bound[0], "bound_by": rr_bound[1], "library_ms": None,
            "ms_warm": statistics.median(t_rr_warm),
            "launches_71": s_launches["raw_read"], "ms_71": statistics.median(t_srr),
            "bound_ms_71": s_rr_bound[0], "ptxas": er_regs.get("raw_read"),
            "sass": er_sass.get("raw_read"),
        },
        {
            "name": "lpc_forward", "route": "cuda",
            "source": "saprobe_alac_tpu_torch/csrc/lpc_kernel.cu",
            "replaces": "saprobe_alac_tpu/ops/lpc_kernel.py:91 (forward=True)",
            "launches": e_launches["lpc_forward"], "max_abs_err": fwd_err,
            "launches_phase20_encode_to_m4a": l20["encode_to_m4a"]["lpc_forward"],
            "launches_phase20_alac_encode": l20["alac_encode"]["lpc_forward"],
            "ms": statistics.median(t_fwd), "ms_one": statistics.median(t_fwd1),
            "plain_ms": fwd_plain_ms,
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": None,
            "cycles_per_row": clk_fwd[1], "sm_mhz": clk_fwd[2],
            "ptxas": {k: v for k, v in lpc_regs.items() if "fwd" in k},
            **case_fields(f_res),
            "sass_loops": lpc_sass and {k: v for k, v in lpc_sass.items() if "fwd" in k},
        },
        {
            "name": "encode", "route": "cuda",
            "source": "saprobe_alac_tpu_torch/csrc/encode_kernel.cu",
            "replaces": "saprobe_alac_tpu/ops/encode_kernel.py:81",
            "launches": e_launches["encode"], "max_abs_err": enc_err,
            "launches_phase20_encode_to_m4a": l20["encode_to_m4a"]["encode"],
            "launches_phase20_alac_encode": l20["alac_encode"]["encode"],
            "ms": statistics.median(t_enc), "plain_ms": enc_plain_ms,
            "bound_ms": enc_bound[0], "bound_by": enc_bound[1], "library_ms": None,
            "lanes": lanes13, "ns_per_sample": clk_enc[0], "cycles_per_sample": clk_enc[1],
            "sm_mhz": clk_enc[2], "ptxas": er_regs.get("encode"), "sass": er_sass.get("encode"),
            "sass_loops": enc_loops,
        },
        {
            "name": "packet", "route": "cuda",
            "source": "saprobe_alac_tpu_torch/csrc/packet_kernel.cu",
            "replaces": "saprobe_alac_tpu/ops/walk_kernel.py:747 (the slot loop around it, "
                        "saprobe_alac_tpu/ops/walk.py:1110)",
            "launches": s_launches["packet"], "max_abs_err": max(pw_err, p_err, pk_err),
            "launches_phase20_track": l20["track"]["packet"],
            "launches_phase20_corpus": l20["corpus"]["packet"],
            **phase21("packet"), "launches_phase23_corpus": l23["packet"],
            "plain_ms_phase20_window64": res20["plain_ms_window64"]["packet"],
            "ms": statistics.median(t_pk), "plain_ms": pk_plain_ms, "plain_on": "host CPU",
            "bound_ms": pk_bound[0], "bound_by": pk_bound[1], "library_ms": None,
            "ns_per_row": clk_pk[0], "cycles_per_row": clk_pk[1], "sm_mhz": clk_pk[2],
            "ptxas": walk_regs.get("packet_kernel"),
            f"plain_ms_B256_F{F14}": p_plain[0],
            "launches_stereo_16bit": launches["packet"], "launches_stereo_hires": h_launches["packet"],
            "ms_stereo_16bit": statistics.median(t_pk16), "plain_ms_stereo_16bit": pk_plain16,
            "bound_ms_stereo_16bit": pk16_bound[0], "cycles_per_row_stereo_16bit": clk_pk16[1],
            "ms_stereo_hires": statistics.median(t_pkh), "plain_ms_stereo_hires": pk_plain_h,
            "bound_ms_stereo_hires": pkh_bound[0], "cycles_per_row_stereo_hires": clk_pkh[1],
            "lpc_ms_L16384": statistics.median(t_slpc), "lpc_plain_ms_L16384": s_lpc_plain,
            "lpc_bound_ms_L16384": s_lpc_bound[0], "lpc_launches": s_launches["lpc"],
            "raw_reads_ms": statistics.median(t_srr), "raw_reads_bound_ms": s_rr_bound[0],
            "raw_read_launches": s_launches["raw_read"],
        },
        {
            "name": "epilogue", "route": "cuda",
            "source": "saprobe_alac_tpu_torch/csrc/epilogue_kernel.cu",
            "replaces": "none: XLA glue in the JAX package (saprobe_alac_tpu/ops/epilogue.py:"
                        "166-283)",
            "launches": s_launches["epilogue"],
            "launches_stereo_16bit": launches["epilogue"],
            "launches_stereo_hires": h_launches["epilogue"],
            "launches_phase20_track": l20["track"]["epilogue"],
            "launches_phase20_corpus": l20["corpus"]["epilogue"],
            **phase21("epilogue"), "launches_phase23_corpus": l23["epilogue"],
            "max_abs_err": max(r["differing_bytes"] for r in res24.values()),
            "ms": res24["7.1"]["ms"], "plain_ms": res24["7.1"]["plain_ms"],
            "bound_ms": res24["7.1"]["bound_ms"], "bound_by": res24["7.1"]["bound_by"],
            "library_ms": None,
            **{f"{key}_{label}": r[key] for label, r in res24.items() if label != "7.1"
               for key in ("ms", "plain_ms", "bound_ms")},
            "ptxas": ep_regs,
        },
        {
            "name": "dense_entropy", "route": "cuda",
            "source": "saprobe_alac_tpu_torch/csrc/dense_entropy_kernel.cu",
            "replaces": "saprobe_alac_tpu/ops/walk_kernel.py:629",
            "launches": de_launches, "max_abs_err": de_err,
            "ms": statistics.median(t_de), "plain_ms": de_plain_full,
            "bound_ms": de_bound[0], "bound_by": de_bound[1], "library_ms": None,
            f"plain_ms_B{B17}_F{F17}": de_plain[0],
            "ns_per_row": clk_de[0], "cycles_per_row": clk_de[1], "sm_mhz": clk_de[2],
            "ptxas": walk_regs.get("dense_entropy_kernel"),
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
