"""The port's profiler (utils/profiling.py) and audio features
(ops/audio.py) on the CPU, and examples/torch_pipeline.py --cpu.

`PhaseTimer` accounts phases as the JAX package's does;
`profile_batch_decode` times the decode path's host stages from their spans
(the names chip_smoke.py prints; tests/test_torch_spans.py holds the spans)
and returns the call's bytes, equal to the source;
`device_trace` writes a Chrome trace.  `pcm_to_float`, `frame_energy` and
`log_spectrogram` match the JAX package's functions within atol 1e-4
(float32; the largest differences measured on these inputs, on a CPU, are
9e-7 for the spectrogram, 1.2e-7 for the frame energy and 0 for the float
conversion)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from conftest import music_pcm

import jax.numpy as jnp
from saprobe_alac_tpu.ops import audio as jax_audio
import saprobe_alac_tpu_torch as port
from saprobe_alac_tpu_torch.ops import audio
from saprobe_alac_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase_timer_accounts_phases():
    timer = profiling.PhaseTimer()
    synced = []
    for _ in range(3):
        with timer.phase("a", sync=lambda: synced.append(1)):
            pass
    with timer.phase("b"):
        sum(range(10000))
    assert timer.counts == {"a": 3, "b": 1} and len(synced) == 3
    assert set(timer.ms()) == {"a", "b"} and all(v >= 0 for v in timer.ms().values())
    report = timer.report().splitlines()
    assert report[0].split() == ["phase", "total", "calls", "share"] and len(report) == 3


@pytest.mark.parametrize("channels", [2, 8])
def test_profile_batch_decode_stages_and_bytes(channels):
    """24-bit bytesShifted=1 stereo and 7.1, a partial last packet: every
    stage timed once a call, and the bytes equal to the source."""
    cfg = port.PacketConfig(128, 24, channels, 40, 10, 14, 255, 0, 0, 48000)
    pcm = music_pcm(3 * 128 - 50, channels, 24, seed=44)
    packets = port.encode_packets(cfg, port.EncoderSpec(bytes_shifted=1), pcm, backend="native")
    timer, out = profiling.profile_batch_decode(cfg, packets, iters=2, device="cpu")
    assert tuple(timer.phases) == profiling.STAGES
    assert all(n == 2 for n in timer.counts.values())
    assert b"".join(out) == pcm.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes()


def test_device_trace_and_profile_call(tmp_path):
    """A Chrome trace of the host's ops; without a card `profile_call`
    times the marked call and sees no device events."""
    x = torch.from_numpy(_mono(1))
    with profiling.device_trace(str(tmp_path)):
        audio.log_spectrogram(x)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any("fft" in e.get("name", "") for e in trace["traceEvents"])
    seconds, events = profiling.profile_call(lambda: audio.log_spectrogram(x))
    assert seconds > 0 and (events == [] or torch.cuda.is_available())


def _mono(seed, shape=(3, 3000)):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("depth", [16, 24])
def test_pcm_to_float_matches_jax(depth):
    s = np.random.default_rng(depth).integers(-(1 << (depth - 1)), 1 << (depth - 1), (2, 64, 2))
    s = s.astype(np.int32)
    got = audio.pcm_to_float(torch.from_numpy(s), depth)
    want = np.asarray(jax_audio.pcm_to_float(jnp.asarray(s), depth))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("frame,hop", [(1024, 512), (256, 100)])
def test_frame_energy_matches_jax(frame, hop):
    x = _mono(frame)
    got = audio.frame_energy(torch.from_numpy(x), frame, hop).numpy()
    want = np.asarray(jax_audio.frame_energy(jnp.asarray(x), frame=frame, hop=hop))
    assert got.shape == want.shape == (3, 1 + (3000 - frame) // hop)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("frame,hop,n_bins", [(512, 256, 128), (256, 128, 129), (128, 64, 40)])
def test_log_spectrogram_matches_jax(frame, hop, n_bins):
    x = _mono(frame + n_bins)
    got = audio.log_spectrogram(torch.from_numpy(x), frame, hop, n_bins).numpy()
    want = np.asarray(jax_audio.log_spectrogram(jnp.asarray(x), frame=frame, hop=hop,
                                                n_bins=n_bins))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_features_of_input_shorter_than_a_frame():
    """No full frame: zero frames, as in the JAX package."""
    x = torch.zeros(2, 100)
    assert audio.frame_energy(x, 128, 64).shape == (2, 0)
    assert audio.log_spectrogram(x, 128, 64, 40).shape == (2, 0, 40)
    want = jax_audio.log_spectrogram(jnp.zeros((2, 100)), frame=128, hop=64, n_bins=40)
    assert want.shape == (2, 0, 40)


def test_torch_pipeline_example_runs_on_the_cpu(capsys):
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import torch_pipeline
    finally:
        sys.path.pop(0)
    assert torch_pipeline.main(["--cpu", "--batch", "3", "--frame", "512"]) == 0
    out = capsys.readouterr().out
    assert "3 packets" in out and "features (3, 1, 128)" in out
