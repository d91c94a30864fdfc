"""Arithmetic the metric readers share: means over the window's calls,
device time by kernel, and a kernel's share of its memory roofline."""

from __future__ import annotations

from . import peaks

#: The trace name of each hand-written kernel of the decode path, by the
#: roofline file that counts its bytes.
KERNELS = ("packet_kernel", "lpc_kernel", "raw_reader_kernel")


def mean(values) -> float | None:
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def per_call(ctx, key: str) -> float | None:
    if not ctx.records:
        return None
    return mean(c.get(key) for c in ctx.records if c["done"])


def is_kernel_of(name: str, kernel: str) -> bool:
    return kernel in name


def kernel_seconds(ctx, kernel: str) -> float:
    """Device seconds in the window of the kernel named ``kernel``."""
    return sum(s for n, s in ctx.trace.op_seconds().items() if is_kernel_of(n, kernel))


def idle_pct(ctx) -> float | None:
    if ctx.trace is None or not ctx.trace.devices or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def roofline_pct(ctx, kernel: str) -> float | None:
    """The kernel's least time, the bytes its inputs and outputs need once
    at the card's published memory rate, over its traced time; None where
    the kernel did not run, the card's peak is unknown or nothing counts
    its bytes."""
    from .harness import module

    rate = peaks.MEMORY_BYTES_PER_S.get(ctx.device_kind)
    if ctx.trace is None or not ctx.records or ctx.shapes is None or rate is None:
        return None
    seconds = kernel_seconds(ctx, kernel)
    nbytes = module("roofline", kernel).bytes_needed(ctx.shapes)
    if seconds <= 0 or nbytes is None:
        return None
    calls = sum(c["done"] for c in ctx.records)
    return 100.0 * calls * nbytes / rate / seconds
