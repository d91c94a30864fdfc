"""``kind: crops`` traffic: a training-data loader's random crops.  ``threads``
loader threads, each a closed loop of crops back to back: a track drawn
uniformly from the library, a start sample drawn uniformly in [0, the
track's samples - ``crop_samples``], both from the seed and the thread's
index; then ``port.new_decoder(open(path, "rb"))`` with its default backend
and window, ``seek_exact(start / sample_rate)``, ``read(crop_samples *
frame bytes)``, and the decoder dropped and the file closed.  Every thread
makes a decoder of its own for every crop; the threads share the port's
process-wide programs.

The library is the configuration's, made as `loops/corpus.py` makes it:
``tiers`` of tracks of ``track_s`` seconds, each a seeded PCM encoded by the
frozen encoder and written by the frozen M4A writer into a temporary
directory.  Set-up then runs rounds of crops on every thread until a round
makes no program and captures nothing: each round the crops whose last
window, or the window dispatched after it, holds m packets near a track's
end, for every m below the facade's window (read from `new_decoder`'s
signature, the window the loop leaves to the port), and seeded random ones.

One record a crop: ``audio_s`` (the crop's seconds), ``ms``, ``done`` (it
returned its full length) and ``thread``.  Traffic parameters:
``check_packets``, how many slices of each crop, a frame of the
configuration long each, are copied for the check: the first from the
crop's first sample, the last ending at its last sample, the others at
seeded offsets; ``check_mib``, the buffer they are copied into, written in
set-up.  A crop is dropped once its slices are copied; past the buffer the
crops kept are a seeded uniform sample of all (reservoir sampling).  The
reference of a crop is the source PCM of its track from its exact start
sample (`inputs.pcm_bytes`); a crop of another length counts its whole
length as bad.
"""

from __future__ import annotations

import importlib
import inspect
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from benchmark import inputs, m4a, reference
from benchmark.loads import input_device, rng, say, span, sync_all
from benchmark.loops.corpus import Track, track_configs, track_seed

#: Rounds of set-up before the window, at least and at most.
WARM_ROUNDS, MAX_WARM_ROUNDS = 2, 8
#: Random crops a thread runs in each round of set-up.
WARM_RANDOM = 4


class Sample:
    """Each crop's seeded slices, copied into a buffer of fixed size; the
    threads offer theirs under one lock."""

    def __init__(self, seed: int, per_crop: int, crop: int, frames: int, frame_bytes: int,
                 mib: float):
        self.reservoir = rng(seed, 3)
        self.per_crop, self.crop, self.frames = per_crop, crop, frames
        self.frame_bytes = frame_bytes
        self.slots = max(1, int(mib * (1 << 20)) // (per_crop * frames * frame_bytes))
        self.buf = np.empty((self.slots, per_crop, frames * frame_bytes), np.uint8)
        self.buf.fill(0)  # its pages, in set-up
        self.kept = {}  # slot -> (track, start, offsets)
        self.offered = 0
        self.lock = threading.Lock()

    def offsets(self, draw: np.random.Generator) -> np.ndarray:
        """A crop's slice offsets in frames: its first, its last, and
        seeded ones between."""
        last = self.crop - self.frames
        return np.concatenate([[0, last], draw.integers(0, last + 1, self.per_crop - 2)])

    def offer(self, t: int, start: int, pcm: bytes, offsets: np.ndarray) -> None:
        """A crop of track ``t`` from ``start`` whose ``pcm`` has the crop's
        length."""
        n = self.frames * self.frame_bytes
        with self.lock:
            k, self.offered = self.offered, self.offered + 1
            slot = k if k < self.slots else int(self.reservoir.integers(k + 1))
            if slot >= self.slots:
                return
            for j, o in enumerate(offsets):
                self.buf[slot, j] = np.frombuffer(pcm, np.uint8, n, int(o) * self.frame_bytes)
            self.kept[slot] = (t, start, offsets)


def run_threads(targets) -> None:
    """Run each callable on a thread of its own and wait for all; re-raise
    the first error a thread raised."""
    errors = []

    def wrap(fn):
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — raised again below
                errors.append(e)

        return run

    threads = [threading.Thread(target=wrap(fn), daemon=True) for fn in targets]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]


class Load:
    def __init__(self, port, config: dict, traffic: dict, seed: int, device: str):
        self.port, self.config, self.traffic, self.seed = port, config, traffic, seed
        self.device = device
        self.control = None
        self.program = importlib.import_module(port.__name__ + ".ops.program")
        # The facade's defaults on the card; a CPU rehearsal names its
        # backend, whose counters are the CPU device's.
        self.kwargs = {} if device == "cuda" else {"backend": device}
        self.counted = "cuda" if device == "cuda" else "cpu"
        self.threads = traffic["threads"]
        self.crop = traffic["crop_samples"]

    def setup(self) -> None:
        t0 = time.perf_counter()
        self.dir = tempfile.TemporaryDirectory(prefix="bench-crops-")
        dev, self.tracks, disk = input_device(self.device), [], 0
        for t, cfg in enumerate(track_configs(self.config)):
            n = round(self.config["track_s"] * cfg["sample_rate"])
            track = Track(cfg, track_seed(self.seed, t), n,
                          str(Path(self.dir.name) / f"track{t:03d}.m4a"))
            if n < self.crop:
                raise ValueError(f"track {t} holds {n} samples, fewer than a crop")
            packets = inputs.encode(cfg, track.source(dev))
            F = cfg["frame_length"]
            disk += m4a.write_m4a(track.path, cfg, packets,
                                  [min(F, n - i * F) for i in range(len(packets))])
            self.tracks.append(track)
        t1 = time.perf_counter()
        self.frame_bytes = self.tracks[0].frame_bytes
        self.sample = Sample(self.seed, self.traffic["check_packets"], self.crop,
                             self.config["frame_length"], self.frame_bytes,
                             self.traffic["check_mib"])
        tails = self.tail_crops()
        rounds, made = 0, None
        while rounds < WARM_ROUNDS or (made and rounds < MAX_WARM_ROUNDS):
            before = self._counts()
            draws = [rng(self.seed, 1000 + self.threads * rounds + i)
                     for i in range(self.threads)]
            run_threads([self.warm(tails[i :: self.threads]
                                   + [self.draw(d) for _ in range(WARM_RANDOM)])
                         for i, d in enumerate(draws)])
            after = self._counts()
            made = {k: after[k] - before[k] for k in ("programs", "captures")
                    if after[k] != before[k]}
            rounds += 1
        if self.device == "cuda":
            sync_all()
        say(f"set-up: {len(self.tracks)} tracks, {disk} bytes of M4A, in {t1 - t0:.3f} s; "
            f"{rounds} rounds of {len(tails)} tail crops and {WARM_RANDOM} random a thread "
            f"(the last made {made or 'nothing'}) and a check buffer of "
            f"{self.sample.slots} crops in {time.perf_counter() - t1:.3f} s")

    def warm(self, crops: list[tuple[int, int]]):
        """A set-up thread's work: ``crops`` one after another, each
        dropped."""
        def run():
            for t, s in crops:
                self.run_crop(t, s)

        return run

    def _counts(self) -> dict:
        return self.program.counts(self.counted)

    def tail_crops(self) -> list[tuple[int, int]]:
        """(track, start) of crops whose last window, or the window
        dispatched after it, holds m packets, one for each m below the
        facade's window, on the tracks in turn: every shape of window a
        crop near a track's end reaches."""
        window = inspect.signature(self.port.new_decoder).parameters["batch_size"].default
        out = []
        for m in range(1, window):
            t = m % len(self.tracks)
            track, F = self.tracks[t], self.tracks[t].config["frame_length"]
            last = track.samples - self.crop
            for p in range(last // F, -1, -1):
                start = min(p * F + 1, last)
                # The windows start at the crop's first packet, a window
                # apart; the one that holds its last sample dispatches the
                # one after it.
                first, final = start // F, (start + self.crop - 1) // F
                end = first + window * ((final - first) // window)
                if m in (track.packets - end, track.packets - end - window):
                    out.append((t, start))
                    break
        return out

    def draw(self, draw: np.random.Generator) -> tuple[int, int]:
        """A seeded crop: (track, start sample)."""
        t = int(draw.integers(len(self.tracks)))
        return t, int(draw.integers(self.tracks[t].samples - self.crop + 1))

    def run_crop(self, t: int, start: int) -> bytes:
        """The port's crop of track ``t`` from ``start``: a decoder of its
        own, dropped before its file is closed."""
        track = self.tracks[t]
        with open(track.path, "rb") as f:
            dec = self.port.new_decoder(f, **self.kwargs)
            dec.seek_exact(start / track.config["sample_rate"])
            pcm = dec.read(self.crop * self.frame_bytes)
            del dec
        return pcm

    def window(self, seconds: float, traced: bool) -> SimpleNamespace:
        records = [[] for _ in range(self.threads)]
        self.short = []  # (track, bytes) of each crop of another length
        fallbacks = self._counts()["fallback_packets"]
        start = time.perf_counter()
        deadline = start + seconds

        def loader(i: int):
            def run():
                draw, offsets = rng(self.seed, 10 + i), rng(self.seed, 200 + i)
                mine = records[i]
                while time.perf_counter() < deadline:
                    t, s = self.draw(draw)
                    t0 = time.perf_counter()
                    try:
                        pcm = self.run_crop(t, s)
                    except Exception as e:  # a failed crop counts as failed, the run goes on
                        mine.append({"audio_s": 0.0, "ms": (time.perf_counter() - t0) * 1e3,
                                     "done": False, "thread": i, "error": repr(e)})
                        continue
                    ms = (time.perf_counter() - t0) * 1e3
                    if self.control is not None:
                        pcm = self.control[t][s * self.frame_bytes :
                                              (s + self.crop) * self.frame_bytes]
                    done = len(pcm) == self.crop * self.frame_bytes
                    mine.append({"audio_s": self.crop / self.tracks[t].config["sample_rate"],
                                 "ms": ms, "done": done, "thread": i})
                    if done:
                        self.sample.offer(t, s, pcm, self.sample.offsets(offsets))
                    else:
                        self.short.append((t, len(pcm)))
                    pcm = None

            return run

        with span(traced, "crops"):
            run_threads([loader(i) for i in range(self.threads)])
        window_s = time.perf_counter() - start
        self.fallbacks = self._counts()["fallback_packets"] - fallbacks
        return SimpleNamespace(window_s=window_s, records=[r for rs in records for r in rs])

    def failed(self, rec: dict) -> bool:
        return not rec["done"]

    def release(self) -> None:
        """Drop the files; the check needs only the seeds."""
        self.dir.cleanup()

    def check(self, win) -> dict:
        """Each crop's length, then each kept slice against the reference's
        bytes of its track's source from the crop's start, made again from
        the track's seed."""
        crop_bytes = self.crop * self.frame_bytes
        bad = compared = crop_bytes * len(self.short)
        s, by_track = self.sample, {}
        for slot, (t, start, offsets) in s.kept.items():
            by_track.setdefault(t, []).append((slot, start, offsets))
        dev = input_device(self.device)
        for t, kept in sorted(by_track.items()):
            track = self.tracks[t]
            src, depth = track.source(dev), track.config["bit_depth"]
            for slot, start, offsets in kept:
                for j, o in enumerate(offsets):
                    a = start + int(o)
                    want = inputs.pcm_bytes(src[a : a + s.frames], depth)
                    bad += reference.differing(s.buf[slot, j, : len(want)].tobytes(), want)
                    compared += len(want)
        return {"bad_bytes": bad, "compared_bytes": compared, "crops_checked": len(s.kept),
                "crops": len(win.records), "crops_short": len(self.short),
                "fallback_packets": self.fallbacks}

    def set_control(self) -> None:
        """Put the control, the reference at one bit less, in the program's
        place: each crop's bytes are replaced by its slice of it."""
        dev = input_device(self.device)
        self.control = [inputs.pcm_bytes(reference.lower_precision(t.source(dev)),
                                         t.config["bit_depth"]) for t in self.tracks]

    def shapes(self) -> None:
        """A crop's windows give the kernels no one shape."""
        return None
