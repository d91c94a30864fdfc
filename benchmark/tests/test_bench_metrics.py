"""The metric arithmetic: a rate over all the window's work, an idle share
from a synthetic trace, a roofline share from a byte count, and the
kernels' byte counts against chip_smoke.py's bounds as PERF.md quotes
them."""

from types import SimpleNamespace

import pytest

from benchmark import harness, peaks
from benchmark.trace import DeviceOp, Trace

H100 = "NVIDIA H100 80GB HBM3"


def ctx(**kw):
    base = dict(cell={}, config={}, traffic={}, setup_s=1.0, window_s=2.0, records=[],
                trace=None, shapes=None, device_kind=H100)
    return harness.Context(**{**base, **kw})


def metric(name, c):
    return harness.module("metrics", name).read(c)


def test_rate_counts_every_completed_call_over_the_whole_window():
    calls = [{"audio_s": 190.0, "done": True}] * 3 + [{"audio_s": 190.0, "done": False}]
    assert metric("decode_rate", ctx(records=calls, window_s=0.5)) == pytest.approx(1140.0)


def synthetic_trace():
    """A 100 ms window on two cards: card 0 busy 10-30 ms (two overlapping
    kernels) and 50-60 ms (a copy), card 1 busy 0-40 ms; harness spans
    around the gaps."""
    ms = 1_000_000
    ops = [DeviceOp(0, "void packet_kernel<2>(int const*)", 10 * ms, 25 * ms),
           DeviceOp(0, "lpc_kernel", 20 * ms, 30 * ms),
           DeviceOp(0, "Memcpy DtoH (Device -> Pinned)", 50 * ms, 60 * ms),
           DeviceOp(1, "elementwise_kernel", 0, 40 * ms),
           DeviceOp(1, "elementwise_kernel", 150 * ms, 160 * ms)]  # outside the window
    spans = [("bench.window", 0, 100 * ms), ("bench.submit", 0, 10 * ms),
             ("bench.finish", 30 * ms, 100 * ms), ("bench.sync", 60 * ms, 61 * ms)]
    return Trace(0, 100 * ms, [0, 1], ops, spans)


def test_idle_share_from_a_synthetic_trace():
    t = synthetic_trace()
    assert t.busy_s() == pytest.approx((0.030 + 0.040) / 2)
    assert metric("device_idle_pct", ctx(trace=t)) == pytest.approx(65.0)
    idle = dict(map(tuple, t.idle_by_host()))
    # Card 0: 0-10 submit, 30-50 and 60-100 finish; card 1: 40-100 finish.
    assert idle == pytest.approx({"submit": 0.010, "finish": 0.020 + 0.040 + 0.060})
    assert t.op_count() == 4


def test_kernel_counts_and_glue_per_call():
    calls = [{"done": True}] * 2
    c = ctx(trace=synthetic_trace(), records=calls)
    assert metric("kernels_per_call", c) == 2.0
    assert metric("glue_ms", c) == pytest.approx(40.0 / 2)  # copies are not kernels


def test_roofline_share_from_a_byte_count():
    shapes = SimpleNamespace(F=4096, C=2, depth=16, bytes_shifted=0, layout=["CPE"],
                             packets=2048, packet_bytes=24_265_752, samples=2048 * 4096)
    calls = [{"done": True}] * 4
    c = ctx(trace=synthetic_trace(), records=calls, shapes=shapes)
    need = harness.module("roofline", "lpc_kernel").bytes_needed(shapes)
    want = 100 * 4 * need / peaks.MEMORY_BYTES_PER_S[H100] / 0.010  # 10 ms of LPC
    assert metric("lpc_roofline", c) == pytest.approx(want)
    assert metric("raw_read_roofline", c) is None  # no reader at 16 bits, no kernel
    assert metric("walk_roofline", ctx(trace=synthetic_trace(), records=calls, shapes=shapes,
                                           device_kind="an unknown card")) is None


def bound_ms(kernel, **shape):
    s = SimpleNamespace(**shape)
    return harness.module("roofline", kernel).bytes_needed(s) / 3.35e12 * 1e3


STEREO = dict(F=4096, C=2, depth=16, bytes_shifted=0, layout=["CPE"], packets=2048,
              samples=2048 * 4096)
HIRES = dict(STEREO, depth=24, bytes_shifted=1)
SURROUND = dict(F=4096, C=8, depth=24, bytes_shifted=1, layout=["SCE", "CPE", "CPE", "CPE", "SCE"],
                packets=2048, samples=2048 * 4096)


@pytest.mark.parametrize("kernel, shape, quoted", [
    # The packets' bytes: what tight staging uploads (chip_smoke.py's bounds) less
    # each row's 4-byte offset and 4-byte size.
    ("packet_kernel", dict(STEREO, packet_bytes=24_282_136 - 8 * 2048), 0.0275),
    ("packet_kernel", dict(SURROUND, packet_bytes=162_949_308 - 8 * 2048), 0.1297),
    ("lpc_kernel", dict(STEREO, packet_bytes=0), 0.0401),
    ("lpc_kernel", dict(SURROUND, packet_bytes=0), 0.1606),
    ("raw_reader_kernel", dict(HIRES, packet_bytes=0), 0.0251),
    ("raw_reader_kernel", dict(SURROUND, packet_bytes=0), 0.1003),
])
def test_byte_counts_reproduce_the_quoted_bounds(kernel, shape, quoted):
    assert round(bound_ms(kernel, **shape), 4) == quoted
