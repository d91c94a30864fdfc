"""``kind: batch`` traffic: a closed loop of one caller,
``BatchDecoder(cfg, "cuda").decode_packets(batch)``, each batch a seeded
order of one pool of ``packets`` distinct packets.

Traffic parameters: ``packets``, the batch and the pool; ``check_packets``,
how many of each call's packets are copied for the check, at positions
drawn from the seed; ``check_mib``, the buffer they are copied into,
allocated and written in set-up.  A call's outputs are dropped once its
sample is copied, as a caller that consumes them would, so what the harness
holds is the same whatever the seed and the number of calls.  Where the
window runs more calls than the buffer holds, the calls kept are a seeded
uniform sample of all of them (reservoir sampling).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from benchmark import inputs, reference
from benchmark.loads import input_device, packet_config, rng, say, span, sync_all

#: Distinct seeded orders of the pool a run cycles through.
ORDERS = 16


class Sample:
    """Each call's seeded positions, copied into a buffer of fixed size."""

    def __init__(self, seed: int, batch: int, per_call: int, packet_bytes: int, mib: float):
        self.positions, self.reservoir = rng(seed, 2), rng(seed, 3)
        self.batch, self.per_call, self.packet_bytes = batch, min(per_call, batch), packet_bytes
        self.slots = max(1, int(mib * (1 << 20)) // (self.per_call * packet_bytes))
        self.buf = np.empty((self.slots, self.per_call, packet_bytes), np.uint8)
        self.buf.fill(0)  # its pages, in set-up
        self.kept = {}  # slot -> (call, order, positions, odd answers, extra bytes)

    def offer(self, k: int, order: int, out) -> None:
        pos = self.positions.choice(self.batch, self.per_call, replace=False)
        slot = k if k < self.slots else int(self.reservoir.integers(k + 1))
        if slot >= self.slots:
            return
        got = list(out) if out is not None else []
        odd = {}  # answers missing or of another length, kept as they came
        for j, p in enumerate(pos):
            b = got[p] if p < len(got) else None
            if b is not None and len(b) == self.packet_bytes:
                self.buf[slot, j] = np.frombuffer(b, np.uint8)
            else:
                odd[j] = b
        extra = sum(len(b) for b in got[self.batch:])  # answers nobody asked for
        self.kept[slot] = (k, order, pos, odd, extra)


class Load:
    def __init__(self, port, config: dict, traffic: dict, seed: int, device: str):
        self.port, self.config, self.traffic, self.seed = port, config, traffic, seed
        self.device = device
        self.control = False

    def setup(self) -> None:
        cfg, tr = self.config, self.traffic
        n = tr["packets"]
        t0 = time.perf_counter()
        self.pcm, self.pool = inputs.track(cfg, n * cfg["frame_length"], self.seed,
                                           input_device(self.device))
        t1 = time.perf_counter()
        r = rng(self.seed, 1)
        self.orders = [r.permutation(n) for _ in range(ORDERS)]
        self.batches = [[self.pool[i] for i in o] for o in self.orders]
        self.audio_s = n * cfg["frame_length"] / cfg["sample_rate"]
        per = cfg["frame_length"] * cfg["num_channels"] * reference.BYTES_PER_SAMPLE[
            cfg["bit_depth"]]
        self.sample = Sample(self.seed, n, tr["check_packets"], per, tr["check_mib"])
        self.decoder = self.port.BatchDecoder(packet_config(self.port, cfg), self.device)
        for b in self.batches[:3]:  # eager, capture, replay
            self.decoder.decode_packets(b)
        if self.device == "cuda":
            sync_all()
        say(f"set-up: inputs {t1 - t0:.3f} s, decoder, check buffer of "
            f"{self.sample.slots} calls and warm-up {time.perf_counter() - t1:.3f} s")

    def window(self, seconds: float, traced: bool) -> SimpleNamespace:
        dec, calls = self.decoder, []
        start = time.perf_counter()
        deadline = start + seconds
        k = 0
        while True:
            b = k % len(self.batches)
            batch = self.batches[b]
            rec = {"audio_s": self.audio_s}
            t0 = time.perf_counter()
            try:
                if traced:
                    with span(True, "submit"):
                        handle = dec.decode_async(batch)
                    t1 = time.perf_counter()
                    with span(True, "sync"):
                        sync_all()
                    t2 = time.perf_counter()
                    with span(True, "finish"):
                        out = dec.finish_async(handle, batch)
                    rec["submit_ms"] = (t1 - t0) * 1e3
                    rec["finish_ms"] = (time.perf_counter() - t2) * 1e3
                else:
                    out = dec.decode_packets(batch)
                rec["fallbacks"] = dec.impl.last_fallbacks
                rec["done"] = len(out) == len(batch)
            except Exception as e:  # a failed call counts as failed, the run goes on
                out, rec["error"], rec["done"] = None, repr(e), False
            rec["ms"] = (time.perf_counter() - t0) * 1e3
            if self.control:
                out = [self.control_bytes[i] for i in self.orders[b]]
            self.sample.offer(k, b, out)
            out = None
            calls.append(rec)
            k += 1
            if time.perf_counter() >= deadline:
                break
        return SimpleNamespace(window_s=time.perf_counter() - start, records=calls)

    def failed(self, rec: dict) -> bool:
        return not rec["done"] or rec.get("fallbacks", 0) > 0

    def release(self) -> None:
        self.decoder = None

    def check(self, win) -> dict:
        """Every kept call's sampled answers against the reference's bytes
        of the pool packets they were asked for."""
        expected = reference.packet_bytes(self.config, self.pcm)
        s, bad, compared = self.sample, 0, 0
        for slot, (_, b, pos, odd, extra) in s.kept.items():
            bad += extra
            for j, p in enumerate(pos):
                want = expected[self.orders[b][p]]
                got = odd[j] if j in odd else s.buf[slot, j].tobytes()
                bad += reference.differing(got, want)
                compared += len(want)
        return {"bad_bytes": bad, "compared_bytes": compared, "calls_checked": len(s.kept)}

    def set_control(self) -> None:
        """Put the control, the reference at one bit less, in the program's
        place: each call's output is replaced by it."""
        self.control = True
        self.control_bytes = reference.packet_bytes(self.config,
                                                    reference.lower_precision(self.pcm))

    def shapes(self) -> SimpleNamespace:
        """What the kernels of one call are given, for the roofline files."""
        cfg = self.config
        return SimpleNamespace(
            F=cfg["frame_length"], C=cfg["num_channels"], depth=cfg["bit_depth"],
            bytes_shifted=cfg["bytes_shifted"], layout=cfg["layout"],
            packets=len(self.pool), packet_bytes=sum(len(p) for p in self.pool),
            samples=len(self.pcm),
        )
