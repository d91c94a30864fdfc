#!/usr/bin/env python3
"""Versions of the port's encode, raw reader and LPC kernels side by side on one CUDA card.

    python3 hack/torch_kernel_versions.py [--version LABEL=DIR]... [--case NAME]... [--count-only]

A version is a directory holding a copy of the package
``saprobe_alac_tpu_torch`` and the repo's ``native/`` (an older commit
unpacked with ``git archive``, or a copy of this checkout with an edited
kernel source); without --version this checkout runs alone as "head".
Each version's package is imported under a name of its own
(``port_<LABEL>``), so each builds its kernels with its own ``_build`` (one
nvcc a source, all started together) and runs its own wrappers: nothing
here declares a kernel's C interface.  For each version: the registers,
stack and spills of ``encode_kernel``, ``raw_reader_kernel`` and the LPC
kernel's four instantiations (ptxas), their SASS instructions and loops
(cuobjdump, ``chip_smoke.sass``), and the divide instructions among them
(``chip_smoke.DIVIDE_OPS``).  Unless --count-only, the cases named by
--case (all of them by default), on the main paths' inputs or on inputs
that take a kernel's other bodies (B=2048 packets of F=4096):

  encode  the encode launches of one ``encode_packets_device`` call, 44.1 kHz
          16-bit stereo, order 6 fitted (chip_smoke.py phase 12's call), as
          each version's own path makes them (its ``dense_encode`` calls,
          recorded and replayed); each version's packets equal the first's;
  raw_hires, raw_71  the raw reads of ``extract_shift`` on the 96 kHz 24-bit
          stereo and 48 kHz 24-bit 7.1 batches with bytesShifted=1
          (chip_smoke.py phases 7 and 15), as each version's own
          ``extract_shift`` makes them; each version's planes equal the
          first's;
  dec16, dec71  the LPC decode of the 16-bit stereo (order 4, L=4096) and
          7.1 batches (order 4, L=16,384);
  dec8, decmix, dec47  16-bit stereo at order 8, at orders 4 and 8 in turn
          (every warp holds lanes of both), at orders 4 and 7 in turn (the
          order-7 lanes run the general 9-tap loop);
  dec32   order 12 with every fourth packet order 31, mode 1 (32 taps);
  fwd16   the forward LPC launch of the encode call above;
  fwd47, fwd32  the forward direction on dec47's and dec32's lanes, the
          decoded rows as the signal.

The LPC cases' inputs are made once, by the first version's path, and run
through each version's ``lpc_fir``; each output is held against the plain
version (tolerance 0), whose time is ``plain_ms``.  Then each version's time
by CUDA events, versions in turns: the median of 5 samples, a sample being
all of one call's launches (warm; the raw reads also cold, after a 1 GiB
write flushes L2; an LPC sample is 10 launches back to back,
chip_smoke.LPC_REPS, and ``ms_one`` one launch), and for encode and dec16
the SM cycles a row at the clock nvidia-smi reads during launches.  Prints
one JSON line and writes it to chiprun_out/kernel_versions.json.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (blocks jax and the JAX package first)
import torch  # noqa: E402

#: Packets a batch.
N_PK = 2048
LPC_CASES = ("dec16", "dec71", "dec8", "decmix", "dec47", "dec32", "fwd16", "fwd47", "fwd32")
CASES = ("encode", "raw_hires", "raw_71", *LPC_CASES)
#: (library stem, the kernels in it) for the counts.
LIBRARIES = (("encode_kernel", cs.ENCODE_KERNELS), ("raw_reader_kernel", cs.RAW_KERNELS),
             ("lpc_kernel", cs.LPC_KERNELS))


def load_version(label: str, root: Path):
    """The package under ``root`` imported as ``port_<label>``."""
    name = f"port_{label}"
    pkg = root / "saprobe_alac_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def sub(ver, path: str):
    return importlib.import_module(f"{ver.__name__}.{path}")


def count(ver) -> dict:
    """ptxas and SASS counts of the version's encode, raw reader and LPC
    kernels."""
    b = sub(ver, "_build")
    out = {}
    for stem, kernels in LIBRARIES:
        log = (b._OUT / f"lib{stem}.log").read_text()
        listing = cs.sass(b._OUT / f"lib{stem}.so", kernels) or {}
        regs = cs.ptxas_report(log, kernels)
        for label in kernels:
            code, loops = listing.get(label, (None, None))
            out[label] = {
                "ptxas": regs.get(label),
                "sass": code and len(code),
                "divides": code and sum(any(d in op for d in cs.DIVIDE_OPS) for op in code),
                "sass_loops": loops,
            }
    return out


def recorder(module, attr: str):
    """Wrap ``module.attr`` so each call's arguments are kept: the list."""
    real, seen = getattr(module, attr), []

    def call(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    setattr(module, attr, call)
    return seen, lambda: setattr(module, attr, real)


def config(ver, depth: int, C: int, rate: int):
    return ver.PacketConfig(frame_length=cs.F, bit_depth=depth, num_channels=C, pb=40, mb=10,
                            kb=14, max_run=255, max_frame_bytes=0, avg_bit_rate=0,
                            sample_rate=rate)


def stereo16():
    """The 16-bit stereo music of the encode call and the 16-bit LPC cases,
    and its frames."""
    F = cs.F
    pcm = cs.music_pcm((N_PK - 1) * F + 7 * F // 16, 2, cs.SEED + 7)
    return pcm, [pcm[i : i + F] for i in range(0, len(pcm), F)]


def encode_case(vers):
    """Per version: (a function running its encode launches of one call,
    the rows a thread codes, its launches), after checking every version's
    packets equal the first's."""
    _, chunks = stereo16()
    runs, first = {}, None
    for label, ver in vers.items():
        spec = ver.EncoderSpec(channel=ver.ChannelSpec(order=6, fit=True))
        ed, ek = sub(ver, "ops.encode_device"), sub(ver, "ops.encode_kernel")
        seen, undo = recorder(ed, "dense_encode")
        try:
            pk = ver.encode_packets_device(config(ver, 16, 2, 44100), spec, chunks)
        finally:
            undo()
        if first is None:
            first = pk
        elif pk != first:
            raise AssertionError(f"{label}: packets differ from the first version's")

        def run(seen=seen, ek=ek):
            return [ek.dense_encode(*a, **kw) for a, kw in seen]

        runs[label] = (run, cs.F, len(seen))
    return runs


def raw_case(vers, depth: int, C: int, rate: int):
    """Per version: (a function running the raw reads of one extract_shift
    call, None, its launches), after checking every version's planes equal
    the first's."""
    F = cs.F
    head = next(iter(vers.values()))
    cfg = config(head, depth, C, rate)
    pcm = cs.music_pcm((N_PK - 1) * F + 7 * F // 16, C, cs.SEED + (30 if C == 2 else 70),
                       depth=depth)
    pk = sub(head, "native").encode_packets(cfg, pcm, bytes_shifted=1)
    words, sizes = sub(head, "ops.batch").TorchBatchDecoder(cfg, "cuda")._stage(pk)
    w = sub(head, "ops.walk").walk_batch(words, sizes, F=F, C=C, depth=depth, pb=cfg.pb,
                                         mb=cfg.mb, kb=cfg.kb)
    runs, first = {}, None
    for label, ver in vers.items():
        ep, rr = sub(ver, "ops.epilogue"), sub(ver, "ops.raw_reader")
        seen, undo = recorder(ep, "raw_read")
        try:
            got = ep.extract_shift(words, w.shift_base, w.bs, w.role, w.ns, F=F, C=C)
        finally:
            undo()
        if first is None:
            first = got
        elif not torch.equal(got, first):
            raise AssertionError(f"{label}: shift planes differ from the first version's")

        def run(seen=seen, rr=rr):
            return [rr.raw_read(*a, **kw) for a, kw in seen]

        runs[label] = (run, None, len(seen))
    return runs


def lpc_inputs(head, names) -> dict:
    """name -> (lpc_fir positional arguments, F, taps, forward) for the
    named LPC cases, made by the first version's path."""
    F = cs.F
    native, lk = sub(head, "native"), sub(head, "ops.lpc_kernel")
    lpc_lanes = sub(head, "ops.lpc").lpc_lanes

    def lanes(c, pkts):
        words, sizes = sub(head, "ops.batch").TorchBatchDecoder(c, "cuda")._stage(pkts)
        w = sub(head, "ops.walk").walk_batch(words, sizes, F=F, C=c.num_channels,
                                             depth=c.bit_depth, pb=c.pb, mb=c.mb, kb=c.kb)
        C, L = c.num_channels, words.shape[0] * c.num_channels
        return (w.res, *lpc_lanes(w.order.T.reshape(L), w.mode.T.reshape(L), w.den.T.reshape(L),
                                  w.cb.T.reshape(L), w.ns.repeat(C),
                                  w.coefs.transpose(0, 1).reshape(L, 32)))

    def turns(a, b, every=2):
        return [b[i] if i % every == every - 1 else a[i] for i in range(N_PK)]

    c16 = config(head, 16, 2, 44100)
    pcm, chunks = stereo16()
    orders = {"dec16": (4,), "dec8": (8,), "decmix": (4, 8), "dec47": (4, 7), "fwd47": (4, 7),
              "dec32": (12,), "fwd32": (12,)}
    pk = {o: native.encode_packets(c16, pcm, order=o)
          for o in {o for name in names for o in orders.get(name, ())}}
    pk31 = (native.encode_packets(c16, pcm, order=31, mode=1)
            if {"dec32", "fwd32"} & set(names) else None)
    makers = {
        "dec16": lambda: (lanes(c16, pk[4]), 9),
        "dec8": lambda: (lanes(c16, pk[8]), 9),
        "decmix": lambda: (lanes(c16, turns(pk[4], pk[8])), 9),
        "dec47": lambda: (lanes(c16, turns(pk[4], pk[7])), 9),
        "dec32": lambda: (lanes(c16, turns(pk[12], pk31, every=4)), 32),
    }
    out = {}
    for name in names:
        if name == "dec71":
            c71 = config(head, 24, 8, 48000)
            pcm71 = cs.music_pcm(len(pcm), 8, cs.SEED + 70, depth=24)
            out[name] = (lanes(c71, native.encode_packets(c71, pcm71, bytes_shifted=1)), F, 9,
                         False)
        elif name == "fwd16":
            ed = sub(head, "ops.encode_device")
            ed._calls = calls = []
            try:
                head.encode_packets_device(
                    c16, head.EncoderSpec(channel=head.ChannelSpec(order=6, fit=True)), chunks)
            finally:
                ed._calls = None
            (args, kw), = [(a, kw) for n, a, kw in calls if n == "lpc_forward"]
            out[name] = (args, kw["F"], kw["taps"], True)
        elif name.startswith("fwd"):  # the forward direction on decoded rows
            args, taps = makers[name.replace("fwd", "dec")]()
            rows = lk.lpc_fir(*args, F=F, taps=taps)
            out[name] = ((rows[None].contiguous(), *args[1:]), F, taps, True)
        else:
            args, taps = makers[name]()
            out[name] = (args, F, taps, False)
    return out


def lpc_case(vers, args, F: int, taps: int, fwd: bool):
    """(per version: (a function making its one lpc_fir launch, rows, 1),
    the plain version's ms), after holding every version's output against
    the plain version's."""
    head = next(iter(vers.values()))
    want, plain_ms = cs.timed(lambda: sub(head, "ops.lpc_kernel").lpc_fir_reference(
        *args, F=F, taps=taps, forward=fwd))
    runs = {}
    for label, ver in vers.items():
        def run(lk=sub(ver, "ops.lpc_kernel")):
            return lk.lpc_fir(*args, F=F, taps=taps, forward=fwd)

        if not torch.equal(run(), want):
            raise AssertionError(f"{label}: LPC output differs from the plain version's")
        runs[label] = (run, want.shape[0], 1)
    return runs, plain_ms


def time_case(runs: dict, cold=False, clock=False, reps=1) -> dict:
    out = {label: {"launches": n, "warm": []} for label, (_, _, n) in runs.items()}
    flush = torch.empty(1 << 28, dtype=torch.int32, device="cuda") if cold else None
    for _ in range(cs.RUNS):
        for label, (run, _, _) in runs.items():
            out[label]["warm"] += cs.cuda_times(run, runs=1, reps=reps)
            if reps > 1:
                out[label].setdefault("one", []).extend(cs.cuda_times(run, runs=1))
            if cold:
                run()
                flush.zero_()
                out[label].setdefault("cold", []).append(cs.timed(run)[1])
    for label, (run, rows, _) in runs.items():
        line = out[label]
        line["ms"] = statistics.median(line["warm"])
        for key in ("one", "cold"):
            if key in line:
                line[f"ms_{key}"] = statistics.median(line[key])
        if clock:
            ns, cyc, mhz = cs.walk_clock(run, rows, line["ms"])
            line.update(ns_per_row=ns, cycles_per_row=cyc, sm_mhz=mhz)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--version", action="append", default=[])
    ap.add_argument("--case", action="append", choices=CASES)
    ap.add_argument("--count-only", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    print(cs.card_line(), flush=True)
    specs = [v.partition("=")[::2] for v in a.version] or [("head", str(ROOT))]
    vers = {label: load_version(label, Path(path).resolve()) for label, path in specs}
    with ThreadPoolExecutor(len(vers)) as pool:
        list(pool.map(lambda v: sub(v, "_build").load(), vers.values()))
    result = {"card": cs.card_line(), "versions": {}}
    for label, ver in vers.items():
        result["versions"][label] = {"dir": dict(specs)[label], **count(ver)}
        print(f"{label}: {json.dumps(result['versions'][label])}", flush=True)
    if not a.count_only:
        for ver in vers.values():
            sub(ver, "native").load()
        names = [c for c in CASES if c in (a.case or CASES)]
        lpc = lpc_inputs(next(iter(vers.values())), [n for n in names if n in LPC_CASES])
        raw = {"raw_hires": (24, 2, 96000), "raw_71": (24, 8, 48000)}
        for name in names:
            if name in lpc:
                args, F, taps, fwd = lpc.pop(name)
                runs, plain_ms = lpc_case(vers, args, F, taps, fwd)
                line = {"L": int(args[1].numel()), "taps": taps, "plain_ms": plain_ms,
                        **time_case(runs, clock=name == "dec16", reps=cs.LPC_REPS)}
            elif name in raw:
                line = time_case(raw_case(vers, *raw[name]), cold=True)
            else:
                line = time_case(encode_case(vers), clock=True)
            result[name] = line
            print(f"{name}: {json.dumps(line)}", flush=True)
            torch.cuda.empty_cache()
    (out_dir / "kernel_versions.json").write_text(json.dumps(result))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
