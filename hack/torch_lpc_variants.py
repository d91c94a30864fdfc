#!/usr/bin/env python3
"""Versions of the port's LPC kernel source side by side on one CUDA card.

    python3 hack/torch_lpc_variants.py [--variant LABEL=PATH]... [--count-only]

A variant is a whole kernel source with the entry points of
saprobe_alac_tpu_torch/csrc/lpc_kernel.cu (an older commit's file, or an
edited copy); without --variant the source in this checkout runs alone.
Each is built as the port builds its kernels (`_build.build_kernel`, one
nvcc each, all started together) and launched through the port's own launch
helper (`ops/lpc_kernel.launch`).  For each: the registers and spills of its
four instantiations (ptxas) and the instructions of each loop (SASS,
cuobjdump).  Unless --count-only, on the inputs the main paths give the LPC
kernel and on the inputs that take its other bodies (B=2048 packets of
F=4096, channel-major lanes):

  dec16   16-bit stereo decode, order 4, 9 taps (L=4096);
  dec71   48 kHz 24-bit 7.1 decode, bytesShifted=1, order 4 (L=16,384);
  dec8    16-bit stereo decode at order 8;
  decmix  16-bit stereo packets at orders 4 and 8 in turn (every warp
          holds lanes of both orders);
  dec47   the same at orders 4 and 7 in turn (the order-7 lanes run the
          general 9-tap loop);
  dec32   16-bit stereo at order 12 with every fourth packet order 31,
          mode 1 (the 32-tap variant);
  fwd16   the forward LPC of one encode_packets_device call, 16-bit stereo,
          order 6 fitted (one launch over both channels, L=4096);
  fwd47, fwd32  the forward direction on dec47's and dec32's lanes, the
          decoded rows as the signal;

each variant's output against the plain version (tolerance 0), then its
time by CUDA events, variants in turns: ``ms`` the median of 5 samples of
10 launches back to back (chip_smoke.py's LPC_REPS), ``ms_one`` of 5 single
launches; for dec16 SM cycles a row at the clock nvidia-smi reads during
launches.  Prints one JSON line and writes it to
chiprun_out/lpc_variants.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (blocks jax and the JAX package first)
import torch  # noqa: E402

KERNEL = ROOT / "saprobe_alac_tpu_torch" / "csrc" / "lpc_kernel.cu"


def inputs(F: int, n_pk: int) -> dict:
    """name -> (lpc_fir positional arguments, F, taps, forward) for the
    decode inputs and fwd16; fwd47 and fwd32 are made from decode outputs."""
    import saprobe_alac_tpu_torch as port
    from saprobe_alac_tpu_torch import native
    from saprobe_alac_tpu_torch.ops import encode_device
    from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder
    from saprobe_alac_tpu_torch.ops.lpc import lpc_lanes
    from saprobe_alac_tpu_torch.ops.walk import walk_batch

    def config(depth, ch, rate):
        return port.PacketConfig(frame_length=F, bit_depth=depth, num_channels=ch, pb=40, mb=10,
                                 kb=14, max_run=255, max_frame_bytes=0, avg_bit_rate=0,
                                 sample_rate=rate)

    def lanes(c, pkts):
        words, sizes = TorchBatchDecoder(c, "cuda")._stage(pkts)
        w = walk_batch(words, sizes, F=F, C=c.num_channels, depth=c.bit_depth, pb=c.pb, mb=c.mb,
                       kb=c.kb)
        C, L = c.num_channels, words.shape[0] * c.num_channels
        return (w.res, *lpc_lanes(w.order.T.reshape(L), w.mode.T.reshape(L), w.den.T.reshape(L),
                                  w.cb.T.reshape(L), w.ns.repeat(C),
                                  w.coefs.transpose(0, 1).reshape(L, 32)))

    def turns(a, b, every=2):
        return [b[i] if i % every == every - 1 else a[i] for i in range(n_pk)]

    total = (n_pk - 1) * F + 7 * F // 16
    c16 = config(16, 2, 44100)
    pcm = cs.music_pcm(total, 2, cs.SEED + 7)
    pk = {o: native.encode_packets(c16, pcm, order=o) for o in (4, 7, 8, 12)}
    pk31 = native.encode_packets(c16, pcm, order=31, mode=1)
    c71 = config(24, 8, 48000)
    pk71 = native.encode_packets(c71, cs.music_pcm(total, 8, cs.SEED + 70, depth=24),
                                 bytes_shifted=1)
    encode_device._calls = calls = []
    chunks = [pcm[i : i + F] for i in range(0, len(pcm), F)]
    port.encode_packets_device(c16, port.EncoderSpec(channel=port.ChannelSpec(order=6, fit=True)),
                               chunks)
    encode_device._calls = None
    (f_args, f_kw), = [(a, kw) for n, a, kw in calls if n == "lpc_forward"]
    return {
        "dec16": (lanes(c16, pk[4]), F, 9, False),
        "dec71": (lanes(c71, pk71), F, 9, False),
        "dec8": (lanes(c16, pk[8]), F, 9, False),
        "decmix": (lanes(c16, turns(pk[4], pk[8])), F, 9, False),
        "dec47": (lanes(c16, turns(pk[4], pk[7])), F, 9, False),
        "dec32": (lanes(c16, turns(pk[12], pk31, every=4)), F, 32, False),
        "fwd16": (f_args, f_kw["F"], f_kw["taps"], True),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--count-only", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from saprobe_alac_tpu_torch import _build
    from saprobe_alac_tpu_torch.ops import lpc_kernel

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    print(cs.card_line(), flush=True)
    variants = [v.partition("=")[::2] for v in a.variant] or [("head", str(KERNEL))]
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda v: _build.build_kernel(f"liblpcv_{v[0]}", Path(v[1])),
                              variants))
    result = {"card": cs.card_line(), "variants": {}}
    for (label, path), so in zip(variants, built):
        log = so.with_suffix(".log").read_text()
        info = {"source": path, "ptxas": cs.ptxas_report(log, cs.LPC_KERNELS),
                "sass_loops": cs.sass_loops(so, cs.LPC_KERNELS)}
        result["variants"][label] = info
        print(f"{label}: {json.dumps(info)}", flush=True)
    failed = []
    if not a.count_only:
        _build.load()
        fns = {label: _build.bind_lpc(ctypes.CDLL(str(so)))
               for (label, _), so in zip(variants, built)}
        cases = inputs(cs.F, 2048)
        decoded = {}
        for name in [*cases, "fwd47", "fwd32"]:
            if name in cases:
                args, F, taps, fwd = cases.pop(name)
            else:  # the forward direction on a decode input's lanes and rows
                args, F, taps = decoded.pop(name.replace("fwd", "dec"))
                fwd = True
            res, *lane, coefs = args
            want, plain_ms = cs.timed(
                lambda: lpc_kernel.lpc_fir_reference(*args, F=F, taps=taps, forward=fwd))
            if name in ("dec47", "dec32"):
                decoded[name] = ((want[None].contiguous(), *lane, coefs), F, taps)
            runs = {
                label: (lambda fn=fn[_build.lpc_entry(taps, fwd)]:
                        lpc_kernel.launch(fn, res, lane, coefs, F=F, taps=taps))
                for label, fn in fns.items()
            }
            ok = {label: torch.equal(run(), want) for label, run in runs.items()}
            failed += [f"{label} on {name}" for label, good in ok.items() if not good]
            samples = {label: ([], []) for label in runs}
            for _ in range(cs.RUNS):
                for label, run in runs.items():
                    samples[label][0].extend(cs.cuda_times(run, runs=1, reps=cs.LPC_REPS))
                    samples[label][1].extend(cs.cuda_times(run, runs=1))
            line = {"L": int(lane[0].numel()), "taps": taps, "plain_ms": plain_ms}
            for label, run in runs.items():
                ms, one = samples[label]
                line[label] = {"equal": ok[label], "ms": statistics.median(ms),
                               "ms_one": statistics.median(one), "samples": ms}
                if name == "dec16":
                    _, cyc, mhz = cs.walk_clock(run, want.shape[0], statistics.median(ms))
                    line[label].update(cycles_per_row=cyc, sm_mhz=mhz)
            result[name] = line
            print(f"{name}: {json.dumps(line)}", flush=True)
            del want
        if failed:
            print(f"differs from the plain version: {failed}", file=sys.stderr)
    (out_dir / "lpc_variants.json").write_text(json.dumps(result))
    print(json.dumps(result))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
