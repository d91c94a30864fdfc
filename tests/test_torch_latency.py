"""Small-batch latency of the port: structural tests, the counterpart of
tests/test_latency.py.

A time taken on this CPU says nothing of the card, so these tests pin the
structure that makes a warm B=32 decode cheap there: one host pack and ONE
device program per batch (`program.Program.run`: one CUDA graph replay on a
warm key on the card), never per-packet staging or launches; and the
streaming facade's one dispatch a window.  `chip_smoke.py` phase 22 (d)
measures the warm B=32 latency on the card.
"""

from __future__ import annotations

import io

import numpy as np

from saprobe_alac_tpu.config import PacketConfig
from saprobe_alac_tpu.encoder import EncoderSpec, build_m4a, encode_packets
from saprobe_alac_tpu.ops.batch import JaxBatchDecoder
import saprobe_alac_tpu_torch as port
from saprobe_alac_tpu_torch import native
from saprobe_alac_tpu_torch.ops import program


def _fixture(B, F):
    cfg = PacketConfig(
        frame_length=F, bit_depth=16, num_channels=2, pb=40, mb=10, kb=14,
        max_run=255, max_frame_bytes=0, avg_bit_rate=0, sample_rate=44100,
    )
    t = np.arange(F * B)
    pcm = np.stack(
        [(7000 * np.sin(2 * np.pi * t / 67)).astype(np.int64),
         (7000 * np.sin(2 * np.pi * t / 101)).astype(np.int64)],
        axis=1,
    )
    return cfg, encode_packets(cfg, EncoderSpec(), pcm), pcm


def _count(monkeypatch, owner, name, calls):
    real = getattr(owner, name)

    def counted(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return real(*a, **k)

    monkeypatch.setattr(owner, name, counted)


def test_warm_small_batch_single_dispatch(monkeypatch):
    """A warm B=32 decode_packets performs exactly one host pack and one
    device program run: no per-packet staging or uploads."""
    cfg, pkts, pcm = _fixture(B=32, F=256)
    program.clear()
    dec = port.BatchDecoder(port.PacketConfig(**cfg.__dict__), "cpu")
    want = pcm.astype("<i2").tobytes()
    assert b"".join(dec.decode_packets(pkts)) == want  # the key's first use
    assert b"".join(JaxBatchDecoder(cfg).decode_packets(pkts)) == want

    calls = {}
    _count(monkeypatch, native, "pack_rows", calls)
    _count(monkeypatch, program.Program, "run", calls)
    assert b"".join(dec.decode_packets(pkts)) == want
    assert calls == {"pack_rows": 1, "run": 1}
    (prog,) = program.programs("cpu")
    assert prog.uses == 2
    program.clear()


def test_facade_single_dispatch_per_window(monkeypatch):
    """The streaming facade runs one program a window while reading
    sequentially (with the next window dispatched ahead), never one a
    packet: 48 packets in windows of 16 dispatch at most 4 times."""
    cfg, pkts, pcm = _fixture(B=48, F=128)
    blob = build_m4a(cfg, pkts, [cfg.frame_length] * len(pkts))
    calls = {}
    _count(monkeypatch, program.Program, "run", calls)
    dec = port.new_decoder(io.BytesIO(blob), backend="cpu", batch_size=16)
    assert dec.read() == pcm.astype("<i2").tobytes()
    assert 3 <= calls["run"] <= 4
