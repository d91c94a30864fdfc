#!/usr/bin/env python3
"""The card memory of a corpus of many configs, decoded through the service,
on a given version of the port: the corpus of chip_smoke.py's phase 23
(16 files: channel counts 1, 2, 6 and 8 at 16 and 24 bits, each at 44.1
and 48 kHz, 612 packets of F=4096, written by the port's encoder on the
card), without its lowered-budget pass.

    python3 hack/torch_corpus_memory.py [--tree DIR]

DIR holds a version of ``saprobe_alac_tpu_torch/`` and ``native/`` (say
``git archive <commit> saprobe_alac_tpu_torch native | tar -x -C DIR``);
by default the checkout's own.  After each file it records
torch.cuda.memory_reserved and the bytes the decode programs keep (static
inputs and graph pools): over the process-wide cache's decode programs
where the version has one (emptied of the encoder's programs first), else
over the live decoders' own programs.  Prints one JSON line: the card, the
package's path, each file's (reserved, program bytes), and whether every
file equals its source.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def program_bytes(program, decoder_type, dev) -> int:
    if hasattr(program, "programs"):
        return sum(p.resident_bytes for p in program.programs(dev) if p.kind == "decode")
    return sum((p.pool_bytes or 0) + sum(t.numel() * t.element_size() for t in p.inputs or ())
               for d in gc.get_objects() if type(d) is decoder_type
               for p in d._programs.values())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT), help="directory holding the package")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(ROOT)]
    import chip_smoke as cs  # blocks jax and the JAX package before any import

    import torch

    if not torch.cuda.is_available():
        print("torch_corpus_memory: no CUDA device", file=sys.stderr)
        return 2
    import saprobe_alac_tpu_torch as port
    from saprobe_alac_tpu_torch import _build, native
    from saprobe_alac_tpu_torch.encoder import EncoderSpec, encode_to_m4a
    from saprobe_alac_tpu_torch.ops import program
    from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder

    if not Path(port.__file__).resolve().is_relative_to(tree):
        raise ImportError(f"saprobe_alac_tpu_torch came from {port.__file__}, not {tree}")
    _build.load()
    native.load()
    dev = torch.device("cuda")
    frame = cs.F
    with tempfile.TemporaryDirectory(prefix="corpus_memory_") as tmp:
        paths, sources = [], []
        for i, (ch, depth, rate) in enumerate(cs.CONFIGS23):
            pcm = cs.music_pcm(cs.PACKETS23 * frame - frame // 3, ch, cs.SEED + 230 + i,
                               depth=depth, dev=dev)
            paths.append(Path(tmp) / f"k{i}.{'caf' if i % 2 else 'm4a'}")
            paths[-1].write_bytes(encode_to_m4a(
                port.PCMFormat(rate, depth, ch), pcm, frame_length=frame,
                spec=EncoderSpec(bytes_shifted=int(depth == 24)),
                container=paths[-1].suffix[1:]))
            sources.append(cs.pcm_bytes(pcm, depth))
        del pcm
        if hasattr(program, "clear"):  # the encoder's programs: the decode starts alone
            program.clear()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        steps, equal = [], True
        t0 = time.perf_counter()
        for f in port.iter_decode_corpus(paths):
            equal &= f.pcm == sources[f.index]
            steps.append((torch.cuda.memory_reserved(dev),
                          program_bytes(program, TorchBatchDecoder, dev)))
        seconds = time.perf_counter() - t0
    print(json.dumps({"card": cs.card_line(), "package": port.__file__, "files": len(steps),
                      "equal": equal, "decode_s": seconds,
                      "reserved_and_program_bytes": steps}))
    return 0 if equal and len(steps) == len(paths) else 1


if __name__ == "__main__":
    sys.exit(main())
