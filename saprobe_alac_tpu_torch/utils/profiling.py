"""Profiling and tracing helpers.

Counterpart of saprobe_alac_tpu/utils/profiling.py: a torch.profiler trace
of the device pipeline (`device_trace`), the card's busy time within one
call (`profile_call`), wall-clock phase accounting (`PhaseTimer`), the
port's own spans (`span`, `spans`), and the batch decode path's host stages
read from them (`stage_timer`, `profile_batch_decode`): where the host
holds the card back.

A span records only while a torch.profiler session is recording in the
process, in whichever thread the span is (the profiler's own
`_profiler_enabled` holds only in the thread that started the session, so
the check reads the process-wide flag the profiler sets); otherwise it
costs one check.  Recorded spans are named
``alac.<layer>.<stage>`` (the facade, batch, program and service layers' names
are the constants below, used at every site that records one), enter
`record_function` under their name,
so a Chrome trace shows them beside the card's work, and are kept in
memory, the newest `RING` of them, with their times on the profiler's clock
(Unix-epoch nanoseconds, as kineto stamps its host events).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

import torch

#: A batch call's outer spans: `decode_async` and `finish_async`.
SUBMIT, FINISH = "alac.batch.submit", "alac.batch.finish"
#: Its host stages: the host stage (`_host_stage`), the copy into a
#: program's inputs, the rest of `program.run`, the readbacks and the
#: pinned copy, the ``bytes``; and the host decode of error lanes.
PACK, FILL, DISPATCH = "alac.batch.pack", "alac.program.fill", "alac.program.dispatch"
#: The wait for a program's lock inside ``alac.program.dispatch``: another
#: caller's fill and replay of the same key.
WAIT = "alac.program.wait"
DOWNLOAD, TRIM, FALLBACK = "alac.batch.download", "alac.batch.trim", "alac.batch.fallback"
#: The host stages of one batch call, in order, each recorded once a call
#: (`stage_timer`); `FALLBACK` joins them in a call with error lanes.
STAGES = (PACK, FILL, DISPATCH, DOWNLOAD, TRIM)
#: The corpus service's own stages (service.py), never around a batch
#: call's spans: a file's demux and packet reads, a completed file's join,
#: and the tail flush's taking of the partial batches.
DEMUX, JOIN, FLUSH = "alac.service.demux", "alac.service.join", "alac.service.flush"
#: The streaming facade's (decode.py `Decoder`): the constructor's demux, a
#: seek (`seek_exact`'s skip read inside it), a read, the reads of a
#: window's packets from the container (inside a read or a seek, beside the
#: batch calls), and a decoder let go with a dispatched window.
OPEN, SEEK, READ = "alac.decoder.open", "alac.decoder.seek", "alac.decoder.read"
PACKETS, CLOSE = "alac.decoder.packets", "alac.decoder.close"
#: The most spans kept; older ones are dropped.
RING = 1 << 20

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
        # The profiler's own buffer request and the annotations on the
        # card's timeline (the marked call, the port's spans) are no work
        # of the call.
        ours = (e.name != "profiled_call" and not e.name.startswith(("Activity Buffer", "alac."))
                and not getattr(e, "is_user_annotation", False))
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


#: The module whose ``_is_profiler_enabled`` torch.profiler sets while a
#: session records: one flag for every thread.
_session = torch.autograd.profiler
_ring: deque = deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """What `span` gives while no profiler records: a shared context that
    does nothing."""

    call = None
    recording = False

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb) -> None:
        return None


_OFF = _Off()


class Span:
    """One recorded span: ``name``; ``start_ns`` and ``end_ns`` on the
    profiler's clock; its ``id``, its ``parent``'s id (None at the top of
    its thread), the ``call`` it belongs to (the id of the call's first
    span; every span of one batch call shares it), the ``thread`` and
    ``attrs``.  A site passes attributes that cost something to build only
    where ``recording`` (`set`), so a span off builds none."""

    __slots__ = ("name", "attrs", "id", "parent", "call", "thread", "start_ns", "end_ns", "_rf")
    recording = True

    def __init__(self, name: str, call: int | None, attrs: dict):
        self.name, self.call, self.attrs = name, call, attrs

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self) -> Span:
        stack = _local.__dict__.setdefault("stack", [])
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up else None
        if self.call is None:
            self.call = up.call if up else self.id
        self.thread = threading.get_ident()
        stack.append(self)
        self.start_ns = time.time_ns()
        self._rf = torch.autograd.profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._rf.__exit__(*exc)
        self.end_ns = time.time_ns()
        self._rf = None
        _local.stack.pop()
        _ring.append(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, call={self.call}, "
                f"ms={(self.end_ns - self.start_ns) / 1e6:.3f}, attrs={self.attrs})")


def span(name: str, call: int | None = None, **attrs):
    """A span of ``name`` around a ``with`` block, recorded only while a
    torch.profiler session records (else a shared context that does
    nothing: ``.call`` is None and ``.recording`` False).  ``call``: the
    batch call it belongs to, for a span that closes a call opened
    elsewhere (`finish_async` takes its submit's); by default its
    parent's, or a new call's at the top of a thread."""
    if not _session._is_profiler_enabled:
        return _OFF
    return Span(name, call, attrs)


def spans(start_ns: int | None = None, end_ns: int | None = None) -> list[Span]:
    """The recorded spans that overlap [``start_ns``, ``end_ns``], by start."""
    return sorted((s for s in _ring.copy()
                   if (start_ns is None or s.end_ns >= start_ns)
                   and (end_ns is None or s.start_ns <= end_ns)),
                  key=lambda s: (s.start_ns, s.id))


def clear_spans() -> None:
    _ring.clear()


def own_ns(recorded: list[Span]) -> dict[int, int]:
    """Each span's own nanoseconds: its duration less its children's (a
    thread's spans nest, so its children do not overlap)."""
    own = {s.id: s.end_ns - s.start_ns for s in recorded}
    for s in recorded:
        if s.parent in own:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


@contextlib.contextmanager
def stage_timer():
    """Run the block under a CPU-activity torch.profiler session and yield a
    `PhaseTimer`, filled when the block ends with each of `STAGES`' own
    time (`own_ns`) over this thread's spans of the block, and
    ``alac.batch.fallback``'s where the block recorded one.  A stage's
    count is its spans' number.  No other profiler session may be open."""
    from torch.profiler import ProfilerActivity, profile

    timer, me = PhaseTimer(), threading.get_ident()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        yield timer
    mine = [s for s in spans(t0) if s.thread == me]
    own = own_ns(mine)
    names = STAGES + ((FALLBACK,) if any(s.name == FALLBACK for s in mine) else ())
    for name in names:
        of = [s for s in mine if s.name == name]
        timer.phases[name] = sum(own[s.id] for s in of) / 1e9
        timer.counts[name] = len(of)


def profile_batch_decode(config, packets, iters: int = 3, device="cuda"):
    """The host stages of the batch decode path on ``device``: two warm
    calls (a key's first use runs eagerly, its second captures), then
    ``iters`` calls of `decode_packets` as a caller makes them (on a card,
    graph replays), timed by their spans (`stage_timer`).  Returns
    (PhaseTimer, the last call's bytes), so a caller can hold the bytes
    against the source."""
    from ..ops.batch import TorchBatchDecoder

    impl = TorchBatchDecoder(config, device)
    for _ in range(2):
        impl.decode_packets(packets)
    out = None
    with stage_timer() as timer:
        for _ in range(iters):
            out = impl.decode_packets(packets)
    return timer, out
