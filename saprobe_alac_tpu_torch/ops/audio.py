"""Audio features of decoded PCM on the tensor's own device.

Counterpart of saprobe_alac_tpu/ops/audio.py: decoded samples stay on the
card and feed feature extraction there, so only the features cross back to
the host (examples/torch_pipeline.py).  Plain PyTorch, the JAX formulas:
float conversion, windowed frame energy and a Hann-windowed log-magnitude
spectrogram (``torch.fft.rfft``, as the JAX package uses ``jnp.fft``).
"""

from __future__ import annotations

import math

import torch


def pcm_to_float(samples: torch.Tensor, depth: int) -> torch.Tensor:
    """Integer decoder output (any shape) -> float32 in [-1, 1)."""
    return samples.to(torch.float32) * (1.0 / (1 << (depth - 1)))


def _num_frames(total: int, frame: int, hop: int) -> int:
    """Number of full analysis frames (0 when the input is too short:
    never a partial frame)."""
    return 0 if total < frame else 1 + (total - frame) // hop


def _frames(x: torch.Tensor, frame: int, hop: int) -> torch.Tensor:
    """(B, n, frame) views of (B, F) audio, n full frames ``hop`` apart."""
    n = _num_frames(x.shape[1], frame, hop)
    idx = torch.arange(n, device=x.device)[:, None] * hop + torch.arange(frame, device=x.device)
    return x[:, idx]


def frame_energy(x: torch.Tensor, frame: int = 1024, hop: int = 512) -> torch.Tensor:
    """Per-frame RMS energy of (B, F) mono float audio: (B, n)."""
    frames = _frames(x, frame, hop)
    return torch.sqrt((frames * frames).mean(dim=-1) + 1e-12)


def log_spectrogram(x: torch.Tensor, frame: int = 512, hop: int = 256,
                    n_bins: int = 128) -> torch.Tensor:
    """Log-magnitude spectrogram of (B, F) mono float audio: (B, n, n_bins),
    log1p of the first ``n_bins`` bins of the rfft of Hann-windowed frames."""
    frames = _frames(x, frame, hop)
    if frames.shape[1] == 0:  # no full frame: an FFT library refuses an empty batch
        return x.new_zeros((x.shape[0], 0, min(n_bins, frame // 2 + 1)))
    k = torch.arange(frame, device=x.device, dtype=x.dtype)
    window = 0.5 - 0.5 * torch.cos(2 * math.pi * k / frame)
    spec = torch.fft.rfft(frames * window, dim=-1).abs()[..., :n_bins]
    return torch.log1p(spec)
