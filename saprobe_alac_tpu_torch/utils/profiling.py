"""Profiling and tracing helpers.

Counterpart of saprobe_alac_tpu/utils/profiling.py: a torch.profiler trace
of the device pipeline (`device_trace`), the card's busy time within one
call (`profile_call`), wall-clock phase accounting (`PhaseTimer`), and the
batch decode path stage by stage, each stage synchronised (`decode_stages`,
`profile_batch_decode`): where the host holds the card back.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

#: The stages of one decode call, in order (`decode_stages`).
STAGES = ("pack_upload", "walk", "lpc_lanes", "lpc", "shift_reads", "epilogue", "download",
          "trim")


def _activities():
    from torch.profiler import ProfilerActivity

    cuda = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    return [ProfilerActivity.CPU, *cuda]


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the host and the card (torch.profiler) while the block runs,
    then write a Chrome trace, ``log_dir/trace.json`` (open it in Perfetto
    or chrome://tracing).  Yields the profiler."""
    from torch.profiler import profile

    with profile(activities=_activities()) as prof:
        yield prof
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def profile_call(fn, sync=None):
    """Run ``fn`` twice under torch.profiler and read the second call: a
    profiler's first records can be lost, and a busy time that misses a
    kernel would pass for a measurement.  Returns (the second call's
    seconds, [(device us, count, name)] of the device events (kernels and
    copies) that started within it, largest first); the list is empty when
    the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, record_function

    sync = sync or (lambda: None)
    with profile(activities=_activities()) as prof:
        fn()
        sync()
        with record_function("profiled_call"):
            t0 = time.perf_counter()
            fn()
            sync()
            seconds = time.perf_counter() - t0
    events = prof.events()
    mark = next(e for e in events if e.name == "profiled_call"
                and e.device_type != DeviceType.CUDA)
    by_name = {}
    for e in events:
        inside = mark.time_range.start <= e.time_range.start <= mark.time_range.end
        # The profiler's own buffer request is no work of the call.
        ours = e.name != "profiled_call" and not e.name.startswith("Activity Buffer")
        if e.device_type == DeviceType.CUDA and inside and ours:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return seconds, sorted(((us, n, key) for key, (us, n) in by_name.items()), reverse=True)


@dataclass
class PhaseTimer:
    """Wall-clock per-phase accounting with blocking boundaries."""

    phases: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time a phase; ``sync`` (e.g. torch.cuda.synchronize) runs on the
        phase result boundary if provided."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    def ms(self) -> dict[str, float]:
        """Each phase's total in milliseconds."""
        return {name: t * 1e3 for name, t in self.phases.items()}

    def report(self) -> str:
        total = sum(self.phases.values()) or 1.0
        lines = [f"{'phase':<24}{'total':>10}{'calls':>8}{'share':>8}"]
        for name, t in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name:<24}{t*1e3:>8.1f}ms{self.counts[name]:>8}{100*t/total:>7.1f}%"
            )
        return "\n".join(lines)


def decode_stages(impl, packets, timer: PhaseTimer):
    """One decode of ``packets`` by ``impl`` (a `TorchBatchDecoder`, padded
    or tight) stage by stage, each stage synchronised and added to
    ``timer`` under its name in `STAGES`.  The LPC's lane setup and its
    kernel are stages of their own; a batch with an order 9..30 lane runs
    the 32-tap LPC, and error lanes decode on the host within ``trim``, as
    ``impl.finish_async`` would.  Returns (the call's bytes, the bytes the
    download copied)."""
    from ..ops.batch import _host_decode
    from ..ops.epilogue import extract_shift, finish_packed
    from ..ops.lpc import lpc_fir, lpc_lanes
    from ..ops.walk import ERR_NONE, walk_batch

    c = impl.config
    F, C, depth = c.frame_length, c.num_channels, c.bit_depth
    dev = impl.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else None
    if sync:
        sync()

    def stage(name):
        return timer.phase(name, sync)

    with stage("pack_upload"):
        words, sizes = impl._stage(packets)
    with stage("walk"):
        w = walk_batch(words, sizes, F=F, C=C, depth=depth, pb=c.pb, mb=c.mb, kb=c.kb)
    L = words.shape[0] * C
    with stage("lpc_lanes"):
        lanes = lpc_lanes(w.order.T.reshape(L), w.mode.T.reshape(L), w.den.T.reshape(L),
                          w.cb.T.reshape(L), w.ns.repeat(C),
                          w.coefs.transpose(0, 1).reshape(L, 32))
        taps = 32 if bool(((w.order >= 9) & (w.order <= 30)).any()) else 9
    with stage("lpc"):
        mix = lpc_fir(w.res, *lanes, F=F, taps=taps)[:F]
    with stage("shift_reads"):
        shift = (extract_shift(words, w.shift_base, w.bs, w.role, w.ns, F=F, C=C)
                 if depth in (24, 32) else None)
    with stage("epilogue"):
        packed = finish_packed(mix, shift, w.bs, w.mixbits, w.mixres, w.role, w.out_chan,
                               w.filled, C=C, depth=depth)
    with stage("download"):
        host, buf = impl._download(packed)
    try:
        with stage("trim"):
            err, ns = w.err.cpu().numpy(), w.ns.cpu().numpy()
            bad = [i for i in range(len(packets)) if err[i] != ERR_NONE]
            fb = dict(zip(bad, _host_decode(c, [packets[i] for i in bad]))) if bad else {}
            out = [fb[i] if i in fb else impl._to_bytes(host[i], int(ns[i]))
                   for i in range(len(packets))]
    finally:
        impl._release(buf)
    return out, packed.numel() * packed.element_size()


def profile_batch_decode(config, packets, iters: int = 3, device="cuda", tight: bool = False):
    """Per-stage timing of the batch decode path on ``device``: one warm
    call, then ``iters`` calls stage by stage (`decode_stages`), summed in
    the timer.  Returns (PhaseTimer, the last call's bytes), so a caller
    can hold the bytes against the source."""
    from ..ops.batch import TorchBatchDecoder

    impl = TorchBatchDecoder(config, device, tight=tight)
    decode_stages(impl, packets, PhaseTimer())  # warm: first launches build and load
    timer = PhaseTimer()
    out = None
    for _ in range(iters):
        out, _ = decode_stages(impl, packets, timer)
    return timer, out
