#!/usr/bin/env python3
"""The corpus service's packet reads on the ingest cell's own files: the
library of `benchmark/configs/lossless_library.json` (12 M4A tracks of
Apple's four ALAC tiers), written as the benchmark writes it, then read
back in turns by each way of reading a file's packets:

- ``per_packet``: one seek and one read a packet;
- ``runs_<n>MiB``: `service._read_packets`, runs of at most n MiB read with
  one ``readinto`` each into one buffer made once a pass.

Each round times every way once over the 12 files (the order rotated from
round to round), and the parse of the sample tables alone
(`decode.demux_stream`), with no profiler.  The files are warm in the page
cache.  Then two passes of `iter_decode_corpus(paths)` on the device, the
second counted (``service_reads``, ``files``).

    python3 hack/torch_service_reads.py [--rounds N] [--track-s S] [--device cuda|cpu]
                                        [--seed N] [--out FILE]

``--track-s`` shortens the tracks for a rehearsal on the CPU.  Prints one
JSON line: the device, each way's ms a pass by round and its reads a
pass, the parse's ms a pass by round, and the counted pass.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MIB = 1 << 20


def per_packet(reader, name, samples) -> tuple[list[bytes], int]:
    """One seek and one read a packet."""
    packets = []
    for info in samples:
        reader.seek(info.offset)
        data = reader.read(info.size)
        if len(data) < info.size:
            raise EOFError(f"{name}: short packet read")
        packets.append(data)
    return packets, len(samples)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--track-s", type=float, default=None, help="track length (s)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=2210000001)
    ap.add_argument("--bounds", default="1,4,8,16", help="run bounds, MiB")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

    from benchmark import inputs, m4a
    from benchmark.loads import input_device
    from benchmark.loops.corpus import Track, track_configs, track_seed
    from saprobe_alac_tpu_torch import service
    from saprobe_alac_tpu_torch.decode import demux_stream
    from saprobe_alac_tpu_torch.ops import program

    config = json.loads((ROOT / "benchmark/configs/lossless_library.json").read_text())
    if args.track_s is not None:
        config["track_s"] = args.track_s
    bounds = [int(b) for b in args.bounds.split(",")]
    ways = {"per_packet": None} | {f"runs_{b}MiB": b * MIB for b in bounds}
    out = {"device": args.device, "seed": args.seed, "track_s": config["track_s"]}
    if args.device == "cuda":
        import torch

        out["card"] = torch.cuda.get_device_name()

    with tempfile.TemporaryDirectory(prefix="service-reads-") as d:
        t0 = time.perf_counter()
        paths, disk = [], 0
        for t, cfg in enumerate(track_configs(config)):
            n = round(config["track_s"] * cfg["sample_rate"])
            track = Track(cfg, track_seed(args.seed, t), n, str(Path(d) / f"track{t:03d}.m4a"))
            packets = inputs.encode(cfg, track.source(input_device(args.device)))
            F = cfg["frame_length"]
            disk += m4a.write_m4a(track.path, cfg, packets,
                                  [min(F, n - i * F) for i in range(len(packets))])
            paths.append(track.path)
        out["files"], out["m4a_bytes"] = len(paths), disk
        out["make_s"] = time.perf_counter() - t0

        tables = []
        for p in paths:
            with open(p, "rb") as f:
                tables.append(demux_stream(f)[1])
        out["packets"] = sum(map(len, tables))
        # Every way gives the per-packet bytes.
        for p, samples in zip(paths, tables):
            with open(p, "rb") as f:
                want, _ = per_packet(f, p, samples)
                for bound in bounds:
                    got, _ = service._read_packets(f, p, samples, bytearray(bound * MIB))
                    assert got == want, (p, bound)
        del want, got

        ms = {w: [] for w in ways}
        reads = {}
        parse_ms = []
        names = list(ways)
        for r in range(args.rounds):
            t = time.perf_counter()
            for p in paths:
                with open(p, "rb") as f:
                    demux_stream(f)
            parse_ms.append((time.perf_counter() - t) * 1e3)
            for w in names[r % len(names):] + names[: r % len(names)]:
                bound = ways[w]
                n = 0
                t = time.perf_counter()
                buf = bytearray(bound) if bound else None
                for p, samples in zip(paths, tables):
                    with open(p, "rb") as f:
                        if buf is None:
                            packets, k = per_packet(f, p, samples)
                        else:
                            packets, k = service._read_packets(f, p, samples, buf)
                    n += k
                    del packets
                ms[w].append((time.perf_counter() - t) * 1e3)
                reads[w] = n
        out["read_ms_a_pass"], out["reads_a_pass"], out["parse_ms_a_pass"] = ms, reads, parse_ms

        backend = {} if args.device == "cuda" else {"backend": args.device}
        counted = "cuda" if args.device == "cuda" else "cpu"
        for _ in service.iter_decode_corpus(paths, **backend):
            pass
        before = program.counts(counted)
        t = time.perf_counter()
        yielded = sum(1 for _ in service.iter_decode_corpus(paths, **backend))
        out["decode_pass_s"] = time.perf_counter() - t
        after = program.counts(counted)
        out["pass_counts"] = {k: after[k] - before[k] for k in ("service_reads", "files")}
        out["pass_yielded"] = yielded
        out["read_run_bytes"] = service.READ_RUN_BYTES

    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
