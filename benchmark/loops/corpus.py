"""``kind: corpus`` traffic: a closed loop of one caller running whole passes
of ``port.iter_decode_corpus(paths)``, with its default arguments, over a
library of M4A files, the same seeded order of the files every pass.

The configuration gives the library: ``tiers``, each a stream format
(``sample_rate``, ``bit_depth``, ``num_channels``, ``layout``,
``bytes_shifted``) and its number of ``tracks``, of ``track_s`` seconds
each, under the configuration's frame, tunings, ``music`` and ``encoder``.
Set-up makes each track's PCM from a seed of its own, encodes it with the
frozen encoder (`inputs.encode`), writes it as an M4A file with the frozen
writer (`m4a.py`) into a temporary directory, and runs whole passes until
one makes no program and captures nothing (at least three: eager, capture,
replay).

One record a yielded file: ``audio_s``, ``ms`` (since the previous yield or
the pass's start) and ``done`` (its length is the file's and its index is
new in the pass).  Traffic parameters: ``check_packets``, how many
packet-sized slices of each file are copied for the check, at packets
drawn from the seed; ``check_mib``, the buffer they are copied into,
written in set-up.  A file is dropped once its slices are copied, as a
consumer would; past the buffer, the files kept are a seeded uniform
sample of all (reservoir sampling).  Each file's length, format and
index are checked whole: a file missing from a pass, of another length or
format, or seen twice in a pass counts its whole expected length as bad.
"""

from __future__ import annotations

import importlib
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from benchmark import inputs, m4a, reference
from benchmark.loads import input_device, rng, say, span, sync_all

#: Passes of set-up before the window, at least and at most.
WARM_PASSES, MAX_WARM_PASSES = 3, 8


class Track:
    """One file of the library: its configuration (the tier's format over
    the configuration's), seed, samples, packets and path."""

    def __init__(self, config: dict, seed: int, samples: int, path: str):
        self.config, self.seed, self.samples, self.path = config, seed, samples, path
        self.packets = -(-samples // config["frame_length"])

    @property
    def frame_bytes(self) -> int:
        return self.config["num_channels"] * reference.BYTES_PER_SAMPLE[self.config["bit_depth"]]

    @property
    def packet_bytes(self) -> int:
        return self.config["frame_length"] * self.frame_bytes

    @property
    def expected_bytes(self) -> int:
        return self.samples * self.frame_bytes

    @property
    def audio_s(self) -> float:
        return self.samples / self.config["sample_rate"]

    @property
    def format(self) -> tuple:
        c = self.config
        return c["sample_rate"], c["bit_depth"], c["num_channels"]

    def source(self, dev=None) -> np.ndarray:
        """The track's source PCM, made again from its seed."""
        music = dict(inputs.MUSIC, **self.config.get("music", {}))
        return inputs.music_pcm(self.samples, self.config["num_channels"], self.seed,
                                tonality=music["tonality"], depth=self.config["bit_depth"],
                                dev=dev)


def track_configs(config: dict) -> list[dict]:
    """Each track's configuration, tier by tier."""
    shared = {k: v for k, v in config.items() if k != "tiers"}
    return [dict(shared, **{k: v for k, v in tier.items() if k != "tracks"})
            for tier in config["tiers"] for _ in range(tier["tracks"])]


def track_seed(seed: int, t: int) -> int:
    return int(rng(seed, 100 + t).integers(1 << 62))


class Sample:
    """Each file's seeded packet-sized slices, copied into a buffer of fixed
    size."""

    def __init__(self, seed: int, per_file: int, slice_bytes: int, mib: float):
        self.positions, self.reservoir = rng(seed, 2), rng(seed, 3)
        self.per_file, self.slice_bytes = per_file, slice_bytes
        self.slots = max(1, int(mib * (1 << 20)) // (per_file * slice_bytes))
        self.buf = np.empty((self.slots, per_file, slice_bytes), np.uint8)
        self.buf.fill(0)  # its pages, in set-up
        self.kept = {}  # slot -> (track, packets)

    def offer(self, k: int, t: int, track: Track, pcm: bytes) -> None:
        """The ``k``-th file of the window, track ``t``, whose ``pcm`` has
        the track's length."""
        pos = self.positions.choice(track.packets, min(self.per_file, track.packets),
                                    replace=False)
        slot = k if k < self.slots else int(self.reservoir.integers(k + 1))
        if slot >= self.slots:
            return
        view, per = memoryview(pcm), track.packet_bytes
        for j, p in enumerate(pos):
            piece = view[p * per : (p + 1) * per]
            self.buf[slot, j, : len(piece)] = np.frombuffer(piece, np.uint8)
        self.kept[slot] = (t, pos)


class Load:
    def __init__(self, port, config: dict, traffic: dict, seed: int, device: str):
        self.port, self.config, self.traffic, self.seed = port, config, traffic, seed
        self.device = device
        self.control = None
        self.program = importlib.import_module(port.__name__ + ".ops.program")
        # The service's defaults on the card; a CPU rehearsal names its
        # backend, whose counters are the CPU device's.
        self.kwargs = {} if device == "cuda" else {"backend": device}
        self.counted = "cuda" if device == "cuda" else "cpu"

    def setup(self) -> None:
        t0 = time.perf_counter()
        self.dir = tempfile.TemporaryDirectory(prefix="bench-corpus-")
        dev, self.tracks, disk = input_device(self.device), [], 0
        for t, cfg in enumerate(track_configs(self.config)):
            seed = track_seed(self.seed, t)
            n = round(self.config["track_s"] * cfg["sample_rate"])
            track = Track(cfg, seed, n, str(Path(self.dir.name) / f"track{t:03d}.m4a"))
            packets = inputs.encode(cfg, track.source(dev))
            F = cfg["frame_length"]
            disk += m4a.write_m4a(track.path, cfg, packets,
                                  [min(F, n - i * F) for i in range(len(packets))])
            self.tracks.append(track)
        t1 = time.perf_counter()
        self.order = rng(self.seed, 1).permutation(len(self.tracks))
        self.paths = [self.tracks[t].path for t in self.order]
        tr = self.traffic
        self.sample = Sample(self.seed, tr["check_packets"],
                             max(t.packet_bytes for t in self.tracks), tr["check_mib"])
        passes, made = 0, None
        while passes < WARM_PASSES or (made and passes < MAX_WARM_PASSES):
            before = self._counts()
            for _ in self.port.iter_decode_corpus(self.paths, **self.kwargs):
                pass
            after = self._counts()
            made = {k: after[k] - before[k] for k in ("programs", "captures")
                    if after[k] != before[k]}
            passes += 1
        if self.device == "cuda":
            sync_all()
        audio_s = sum(t.audio_s for t in self.tracks)
        say(f"set-up: {len(self.tracks)} tracks, {audio_s:.0f} s of audio, {disk} bytes of "
            f"M4A, in {t1 - t0:.3f} s; {passes} passes "
            f"(the last made {made or 'nothing'}) and a check buffer of "
            f"{self.sample.slots} files in {time.perf_counter() - t1:.3f} s")

    def _counts(self) -> dict:
        return self.program.counts(self.counted)

    def window(self, seconds: float, traced: bool) -> SimpleNamespace:
        files, k = [], 0
        self.seen, self.missing = [], []  # the whole-file checks' findings
        fallbacks = self._counts()["fallback_packets"]
        start = time.perf_counter()
        deadline = start + seconds
        self.passes = 0
        while True:
            got: set[int] = set()
            t_prev = time.perf_counter()
            try:
                it = self.port.iter_decode_corpus(self.paths, **self.kwargs)
                while True:
                    with span(traced, "ingest"):
                        res = next(it, None)
                    if res is None:
                        break
                    now = time.perf_counter()
                    i = res.index
                    t = int(self.order[i]) if 0 <= i < len(self.order) else None
                    track = self.tracks[t] if t is not None else None
                    pcm = res.pcm if self.control is None or t is None else self.control[t]
                    fmt = (res.format.sample_rate, res.format.bit_depth, res.format.channels)
                    sized = track is not None and len(pcm) == track.expected_bytes
                    done = sized and i not in got
                    self.seen.append((t, len(pcm), sized,
                                      track is not None and fmt == track.format, i in got))
                    got.add(i)
                    files.append({"audio_s": track.audio_s if track else 0.0,
                                  "ms": (now - t_prev) * 1e3, "done": done})
                    if done:
                        with span(traced, "sample"):
                            self.sample.offer(k, t, track, pcm)
                        k += 1
                    res = pcm = None
                    t_prev = now
            except Exception as e:  # a failed pass counts as failed, the run goes on
                files.append({"audio_s": 0.0, "ms": (time.perf_counter() - t_prev) * 1e3,
                              "done": False, "error": repr(e)})
            self.missing += [int(self.order[i]) for i in range(len(self.order)) if i not in got]
            self.passes += 1
            if time.perf_counter() >= deadline:
                break
        window_s = time.perf_counter() - start
        self.fallbacks = self._counts()["fallback_packets"] - fallbacks
        return SimpleNamespace(window_s=window_s, records=files)

    def failed(self, rec: dict) -> bool:
        return not rec["done"]

    def release(self) -> None:
        """Drop the files; the check needs only the seeds."""
        self.dir.cleanup()

    def check(self, win) -> dict:
        """Each yielded file whole (length, format, once a pass) and every
        file a pass (none missing), then each kept slice against the
        reference's bytes of its track's source, made again from its seed."""
        bad = compared = 0
        for t, nbytes, sized, formatted, twice in self.seen:
            if t is None:  # an index no file has: bytes nobody asked for
                bad += nbytes
            elif not (sized and formatted) or twice:
                bad += self.tracks[t].expected_bytes
                compared += self.tracks[t].expected_bytes
        for t in self.missing:
            bad += self.tracks[t].expected_bytes
            compared += self.tracks[t].expected_bytes
        s, by_track = self.sample, {}
        for slot, (t, pos) in s.kept.items():
            by_track.setdefault(t, []).append((slot, pos))
        dev = input_device(self.device)
        for t, kept in sorted(by_track.items()):
            track = self.tracks[t]
            src, F, depth = track.source(dev), track.config["frame_length"], track.config[
                "bit_depth"]
            for slot, pos in kept:
                for j, p in enumerate(pos):
                    want = inputs.pcm_bytes(src[p * F : (p + 1) * F], depth)
                    bad += reference.differing(s.buf[slot, j, : len(want)].tobytes(), want)
                    compared += len(want)
        return {"bad_bytes": bad, "compared_bytes": compared, "files_checked": len(s.kept),
                "files": len(self.seen), "passes": self.passes,
                "files_missing": len(self.missing), "fallback_packets": self.fallbacks}

    def set_control(self) -> None:
        """Put the control, the reference at one bit less, in the program's
        place: each file's bytes are replaced by it."""
        dev = input_device(self.device)
        self.control = [inputs.pcm_bytes(reference.lower_precision(t.source(dev)),
                                         t.config["bit_depth"]) for t in self.tracks]

    def shapes(self) -> None:
        """A mixed corpus gives the kernels no single shape."""
        return None
