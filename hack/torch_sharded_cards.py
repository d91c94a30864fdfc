#!/usr/bin/env python3
"""`ShardedBatchDecoder` over every card of one host against the one-card
decoder, on chip_smoke.py's phase 4 (44.1 kHz 16-bit stereo) and phase 15
(48 kHz 24-bit 7.1, bytesShifted=1) batches of B=2048 packets of F=4096,
and on phase 4's first 2047 packets.

    python3 hack/torch_sharded_cards.py        # on a host with two cards or more

For each batch: `BatchDecoder(cfg)` must build the sharded decoder; its
bytes must equal the source and the one-card decoder's, with each path
kernel launched once a shard and every shard's output on its own card; then
both are timed by the host clock (median of 5 warm runs); then one more
sharded call, a replay of each shard's decode program on its card, must give
the same bytes.  Then the four-card cell's shape: 2,048 stereo packets a card
over every card in one call, against one card's call of 2,048, timed the
same way; ``scaling`` is the sharded call's packets a second over one
card's.
Prints a JSON line per batch and OK; raises on any difference.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (blocks jax and the JAX package first)
import torch  # noqa: E402

import saprobe_alac_tpu_torch as port  # noqa: E402
from saprobe_alac_tpu_torch import _build, native  # noqa: E402
from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder  # noqa: E402
from saprobe_alac_tpu_torch.parallel import ShardedBatchDecoder  # noqa: E402


def main() -> int:
    if torch.cuda.device_count() < 2:
        print("torch_sharded_cards: needs two cards or more", file=sys.stderr)
        return 2
    print(cs.card_line(), torch.cuda.device_count(), flush=True)
    _build.load()
    native.load()
    F, n_pk = cs.F, 2048
    total = (n_pk - 1) * F + 7 * F // 16
    cfg = port.PacketConfig(F, 16, 2, 40, 10, 14, 255, 0, 0, 44100)
    pcm = cs.music_pcm(total, 2, cs.SEED + 7)
    pkts = native.encode_packets(cfg, pcm)
    scfg = port.PacketConfig(F, 24, 8, 40, 10, 14, 255, 0, 0, 48000)
    spcm = cs.music_pcm(total, 8, cs.SEED + 70, depth=24)
    spkts = native.encode_packets(scfg, spcm, bytes_shifted=1)
    batches = {"16-bit stereo": (cfg, pkts, pcm), "7.1": (scfg, spkts, spcm),
               "16-bit stereo B=2047": (cfg, pkts[:2047], pcm[: 2047 * F])}
    for label, (c, pk, p) in batches.items():
        bd = port.BatchDecoder(c)
        if not isinstance(bd.impl, ShardedBatchDecoder):
            raise AssertionError(f"BatchDecoder(cfg) built {type(bd.impl).__name__}")
        n = len(bd.impl.devices)
        port.reset_launch_counts()
        out = bd.decode_packets(pk)
        launches = port.launch_counts()
        cs.check_decode(out, p, c.bit_depth)
        want = {"packet": n, "lpc": n, "raw_read": n if c.bit_depth in (24, 32) else 0}
        if any(launches[k] != v for k, v in want.items()) or bd.impl.last_fallbacks:
            raise AssertionError(f"{label}: launches {launches}, want {want}; "
                                 f"{bd.impl.last_fallbacks} host fallbacks")
        handle = bd.impl.decode_async(pk)
        devices = sorted({str(h[0].device) for h, _ in handle if h is not None})
        bd.impl.finish_async(handle, pk)
        one = TorchBatchDecoder(c, "cuda:0")
        if one.decode_packets(pk) != out:
            raise AssertionError(f"{label}: the sharded bytes differ from one card's")
        res = {"cards": n, "shard_devices": devices, "launches": launches,
               "sharded_s": cs.summary(cs.host_times(lambda: bd.decode_packets(pk))),
               "one_card_s": cs.summary(cs.host_times(lambda: one.decode_packets(pk)))}
        # Warm now: each shard's call is one replay of its program on its card.
        port.reset_launch_counts()
        if bd.decode_packets(pk) != out:
            raise AssertionError(f"{label}: the sharded replays' bytes differ")
        res["launches_warm"] = port.launch_counts()
        if res["launches_warm"]["replay"] != n:
            raise AssertionError(f"{label}: warm launches {res['launches_warm']}, want {n} replays")
        print(label, json.dumps(res), flush=True)
    n = torch.cuda.device_count()
    bd, one = port.BatchDecoder(cfg), TorchBatchDecoder(cfg, "cuda:0")
    big = pkts * n
    out = bd.decode_packets(big)
    for r in range(n):
        cs.check_decode(out[r * n_pk : (r + 1) * n_pk], pcm, 16)
    sharded = cs.summary(cs.host_times(lambda: bd.decode_packets(big)))
    single = cs.summary(cs.host_times(lambda: one.decode_packets(pkts)))
    res = {"cards": n, "packets": len(big), "sharded_s": sharded, "one_card_s": single,
           "scaling": n * single["median"] / sharded["median"]}
    print(f"16-bit stereo, {n_pk} a card", json.dumps(res), flush=True)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
