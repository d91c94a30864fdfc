#!/usr/bin/env python3
"""chip_smoke.py's phase 19 (one BatchDecoder on the card shared by several
threads) against a given version of the port's batch layer, at phase 19's
settings and at heavier ones.

    python3 hack/torch_shared_decoder.py [--batch PATH]

PATH is a version of saprobe_alac_tpu_torch/ops/batch.py (an older commit's
file, say); it is loaded as a module of the package beside the checkout's
own, and both run each setting in turn: 16-bit stereo packets of F=128
(18 packets) and of F=4096 (B=2048, phase 4's), with 4 or 8 threads and
more slices a thread.  Prints one JSON line: for each version and setting,
whether every slice's bytes equal the source, or the check's message.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (blocks jax and the JAX package first)
import torch  # noqa: E402


def facade(batch_module):
    """A `port`-like namespace whose BatchDecoder runs ``batch_module``'s
    TorchBatchDecoder on the card."""

    class BatchDecoder:
        def __init__(self, config):
            self.impl = batch_module.TorchBatchDecoder(config, "cuda")

        def decode_packets(self, packets):
            return self.impl.decode_packets(packets)

    return SimpleNamespace(BatchDecoder=BatchDecoder)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import saprobe_alac_tpu_torch as port
    from saprobe_alac_tpu_torch import native
    from saprobe_alac_tpu_torch.ops import batch

    versions = {"checkout": facade(batch)}
    if a.batch:
        spec = importlib.util.spec_from_file_location("saprobe_alac_tpu_torch.ops._batch_given",
                                                      a.batch)
        given = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(given)
        versions["given"] = facade(given)
    C, F = 2, cs.F
    cfg = port.PacketConfig(frame_length=F, bit_depth=16, num_channels=C, pb=40, mb=10, kb=14,
                            max_run=255, max_frame_bytes=0, avg_bit_rate=0, sample_rate=44100)
    n_pk = 2048
    pcm = cs.music_pcm((n_pk - 1) * F + 7 * F // 16, C, cs.SEED + 7)
    pkts = native.encode_packets(cfg, pcm)
    cfg128 = dataclasses.replace(cfg, frame_length=128)
    pcm128 = cs.music_pcm(128 * 17 + 41, C, 8)
    pk128 = native.encode_packets(cfg128, pcm128)
    settings = {  # label: (config, packets, pcm, slices, seed, threads)
        "F128_phase19": (cfg128, pk128, pcm128, 5, 2000, 4),
        "F4096_phase19": (cfg, pkts, pcm, 3, 3000, 4),
        "F128_8threads_40slices": (cfg128, pk128, pcm128, 40, 2000, 8),
        "F4096_8threads_6slices": (cfg, pkts, pcm, 6, 3000, 8),
    }
    result = {"card": cs.card_line()}
    for name, port_v in versions.items():
        for label, (c, p, x, slices, seed, threads) in settings.items():
            t0 = time.perf_counter()
            try:
                n = cs.shared_decoder(port_v, c, p, x, slices, seed, threads=threads)
                out = {"equal": True, "packets": n}
            except AssertionError as e:
                out = {"equal": False, "error": str(e)}
            out["s"] = time.perf_counter() - t0
            result[f"{name}/{label}"] = out
            print(f"{name}/{label}: {json.dumps(out)}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
