"""The device trace of a window: torch.profiler over the window, reduced to
what the per-layer metrics read.

The harness marks its own spans with `record_function` names starting with
``bench.``; ``bench.window`` spans the whole window.  Device operations are
the profiler's CUDA events that are not annotations: kernels, copies and
memsets.  Busy time is the union of a card's operations inside the window;
an idle gap is labelled by the innermost harness span around its middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "bench.window"
#: The harness's span names, and what the host does inside each.
SPAN_PREFIX = "bench."
#: How many spans back from an idle gap's middle its label is looked for.
LOOK_BACK = 16


@dataclass
class DeviceOp:
    device: int
    name: str
    start_ns: int
    end_ns: int


@dataclass
class Trace:
    """A traced window: its bounds, every device operation in it, and the
    harness's spans (name, start, end), all in the profiler's nanoseconds."""

    start_ns: int
    end_ns: int
    devices: list[int]
    ops: list[DeviceOp] = field(default_factory=list)
    spans: list[tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def merged(self, device: int) -> list[tuple[int, int]]:
        """The card's busy intervals inside the window, merged."""
        iv = sorted((max(o.start_ns, self.start_ns), min(o.end_ns, self.end_ns))
                    for o in self.ops if o.device == device)
        out: list[list[int]] = []
        for s, e in iv:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        """Seconds in which an operation ran, averaged over the cards."""
        per = [sum(e - s for s, e in self.merged(d)) for d in self.devices]
        return sum(per) / len(per) / 1e9 if per else 0.0

    def gaps(self, device: int) -> list[tuple[int, int]]:
        """The card's idle intervals inside the window."""
        out, t = [], self.start_ns
        for s, e in self.merged(device):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.end_ns > t:
            out.append((t, self.end_ns))
        return out

    def idle_by_host(self, top: int = 10) -> list[list]:
        """Idle seconds by what the host was doing (the innermost harness
        span around each gap's middle), summed over the cards, largest
        first."""
        spans = sorted((s, e, n) for n, s, e in self.spans if n != WINDOW)
        starts = [s for s, _, _ in spans]
        total: dict[str, float] = defaultdict(float)
        for d in self.devices:
            for s, e in self.gaps(d):
                mid = (s + e) // 2
                label = "harness"
                # Spans nest, so the innermost one around the middle is the
                # latest-starting one that has not ended; a few steps back
                # reach it (a request holds a handful of spans).
                i = bisect.bisect_right(starts, mid)
                for ss, se, name in reversed(spans[max(0, i - LOOK_BACK) : i]):
                    if se >= mid:
                        label = name[len(SPAN_PREFIX):]
                        break
                total[label] += (e - s) / 1e9
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def op_seconds(self) -> dict[str, float]:
        """Device seconds by operation name, inside the window."""
        out: dict[str, float] = defaultdict(float)
        for o in self.ops:
            s, e = max(o.start_ns, self.start_ns), min(o.end_ns, self.end_ns)
            if e > s:
                out[o.name] += (e - s) / 1e9
        return out

    def top_ops(self, top: int = 10) -> list[list]:
        ops = sorted(self.op_seconds().items(), key=lambda kv: -kv[1])[:top]
        return [[short_name(k), v] for k, v in ops]

    def op_count(self) -> int:
        """Device operations that ran inside the window."""
        return sum(o.end_ns > self.start_ns and o.start_ns < self.end_ns for o in self.ops)


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without its return type and parameter list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:limit]


def _ns(e, what: str) -> int:
    if hasattr(e, f"{what}_ns"):
        return int(getattr(e, f"{what}_ns")())
    return int(getattr(e, f"{what}_us")() * 1000)


def read(prof, devices: list[int]) -> Trace:
    """The `Trace` of a stopped torch.profiler.profile."""
    import torch

    ops, spans, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + (int(e.duration_ns()) if hasattr(e, "duration_ns")
                       else int(e.duration_us() * 1000))
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            annotation = e.is_user_annotation() if hasattr(e, "is_user_annotation") else False
            if not annotation and not name.startswith(SPAN_PREFIX):
                ops.append(DeviceOp(int(e.device_index()), name, start, end))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name, start, end))
            if name == WINDOW:
                window = (start, end)
    if window is None:
        raise RuntimeError("the trace holds no window span")
    return Trace(window[0], window[1], devices, ops, spans)
