"""Audio features of decoded PCM on the tensor's own device.

Counterpart of saprobe_alac_tpu/ops/audio.py: decoded samples stay on the
card and feed feature extraction there, so only the features cross back to
the host (examples/torch_pipeline.py).  Plain PyTorch, the JAX formulas:
float conversion, windowed frame energy and a Hann-windowed log-magnitude
spectrogram (``torch.fft.rfft``, as the JAX package uses ``jnp.fft``).

As the JAX package jits each function (audio.py:16, 29, 39), the two
framed features run as the process-wide program of (device, function,
input shape and dtype, its static arguments) (ops/program.py): on a card,
a key's first call eager on
the caller's tensor (it builds cuFFT's plan), its second captured as a
CUDA graph, every later one one replay.  From the second call the input is
copied on its device into the program's static input.  The frame index and
the window are built inside the core, so a captured graph keeps them in its
pool, which the cache's budget counts, and a key used once keeps nothing.
`pcm_to_float` is one cast and scale and runs as it is: a program would
add a copy in and a clone out of the same bytes (chip_smoke.py phase 21
(d), at B=2048 F=4096 stereo on an NVIDIA H100 80GB HBM3 at 700 W: 0.178
ms as a program against 0.104 ms direct).
"""

from __future__ import annotations

import math

import torch

from . import program


def _run(kind: str, statics: tuple, x: torch.Tensor, fn) -> torch.Tensor:
    """``x`` through the program of (x's device, ``kind``, ``statics``, x's
    shape and dtype), whose core is ``fn``, one tensor to one tensor."""
    shape = (tuple(x.shape), x.dtype)

    def make_program(device):
        return (lambda xs: (fn(xs),)), [shape]

    (out,) = program.run(x.device, kind, statics, shape, make_program, [x])
    return out


def _to_float(samples: torch.Tensor, depth: int) -> torch.Tensor:
    return samples.to(torch.float32) * (1.0 / (1 << (depth - 1)))


def pcm_to_float(samples: torch.Tensor, depth: int) -> torch.Tensor:
    """Integer decoder output (any shape) -> float32 in [-1, 1)."""
    return _to_float(samples, depth)


def _num_frames(total: int, frame: int, hop: int) -> int:
    """Number of full analysis frames (0 when the input is too short:
    never a partial frame)."""
    return 0 if total < frame else 1 + (total - frame) // hop


def _frame_index(total: int, frame: int, hop: int, device) -> torch.Tensor:
    """(n, frame) sample indices of the n full frames ``hop`` apart."""
    n = _num_frames(total, frame, hop)
    return torch.arange(n, device=device)[:, None] * hop + torch.arange(frame, device=device)


def _energy(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    frames = x[:, idx]
    return torch.sqrt((frames * frames).mean(dim=-1) + 1e-12)


def _hann(frame: int, dtype, device) -> torch.Tensor:
    k = torch.arange(frame, device=device, dtype=dtype)
    return 0.5 - 0.5 * torch.cos(2 * math.pi * k / frame)


def _log_spec(x: torch.Tensor, idx: torch.Tensor, window: torch.Tensor,
              n_bins: int) -> torch.Tensor:
    spec = torch.fft.rfft(x[:, idx] * window, dim=-1).abs()[..., :n_bins]
    return torch.log1p(spec)


def frame_energy(x: torch.Tensor, frame: int = 1024, hop: int = 512) -> torch.Tensor:
    """Per-frame RMS energy of (B, F) mono float audio: (B, n)."""
    if _num_frames(x.shape[1], frame, hop) == 0:
        return x.new_zeros((x.shape[0], 0))

    def energy(xs):
        return _energy(xs, _frame_index(xs.shape[1], frame, hop, xs.device))

    return _run("frame_energy", (frame, hop), x, energy)


def log_spectrogram(x: torch.Tensor, frame: int = 512, hop: int = 256,
                    n_bins: int = 128) -> torch.Tensor:
    """Log-magnitude spectrogram of (B, F) mono float audio: (B, n, n_bins),
    log1p of the first ``n_bins`` bins of the rfft of Hann-windowed frames."""
    if _num_frames(x.shape[1], frame, hop) == 0:
        # No full frame: an FFT library refuses an empty batch.
        return x.new_zeros((x.shape[0], 0, min(n_bins, frame // 2 + 1)))

    def log_spec(xs):
        return _log_spec(xs, _frame_index(xs.shape[1], frame, hop, xs.device),
                         _hann(frame, xs.dtype, xs.device), n_bins)

    return _run("log_spectrogram", (frame, hop, n_bins), x, log_spec)
