"""Encoder choices and the element layout tables.

The port's own copy of what saprobe_alac_tpu/encoder/encode.py:44-115 and
saprobe_alac_tpu/codec/element.py hold for the encoders: `ChannelSpec`,
`EncoderSpec`, the host-side least-squares fit of initial coefficients, the
MPEG element layout per channel count, the LFE's bitstream index and the
bitstream-to-SMPTE channel offsets.  numpy only.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

#: Default initial LPC coefficients (den_shift 9 fixed point), a gentle
#: low-order smoother; the adaptive walk tunes them per block.
_DEFAULT_COEFS = [160, 80, 40, 20, 10, 5, 3, 2]

#: Bitstream channel index -> SMPTE output channel, per channel count - 1.
CHANNEL_LAYOUT_OFFSETS = (
    (0,),
    (0, 1),
    (2, 0, 1),
    (2, 0, 1, 3),
    (2, 0, 1, 3, 4),
    (2, 0, 1, 4, 5, 3),
    (2, 0, 1, 4, 5, 6, 3),
    (2, 6, 7, 0, 1, 4, 5, 3),
)

#: Bitstream channel index of the LFE channel (SMPTE output index 3).
LFE_BITSTREAM_IDX = {6: 5, 7: 6, 8: 7}

_ELEMENT_LAYOUT = {
    1: [1], 2: [2], 3: [1, 2], 4: [1, 2, 1], 5: [1, 2, 2],
    6: [1, 2, 2, 1], 7: [1, 2, 2, 1, 1], 8: [1, 2, 2, 2, 1],
}


def element_layout(num_channels: int) -> list[int]:
    """MPEG element sizes per channel count: 1 (SCE/LFE) and 2 (CPE)."""
    return _ELEMENT_LAYOUT[num_channels]


@dataclass
class ChannelSpec:
    """Per-channel encoding choices."""

    order: int = 4
    den_shift: int = 9
    pb_factor: int = 4
    mode: int = 0  # >0 enables the two-stage delta pre-pass
    coefs: list[int] = field(default_factory=list)
    fit: bool = True  # fit initial coefficients per block
    #: Adaptive pbFactor: when non-empty, each channel body is entropy-encoded
    #: once per candidate and the smallest wins (the 3-bit pbFactor field is
    #: per channel header, so the decoder needs no side channel).
    pb_candidates: tuple = ()

    def initial_coefs(self, samples: np.ndarray | None = None) -> list[int]:
        if self.coefs:
            given = list(self.coefs[: self.order])
            return given + [0] * (self.order - len(given))  # pad short lists
        if self.fit and samples is not None and self.order > 0:
            fitted = _fit_coefs(samples, self.order, self.den_shift)
            if fitted is not None:
                return fitted
        base = (_DEFAULT_COEFS * 4)[: self.order]
        return [c << max(0, self.den_shift - 9) for c in base]


def _fit_coefs(samples: np.ndarray, order: int, den_shift: int) -> list[int] | None:
    """Least-squares LPC fit quantized to int16 range at den_shift fixed
    point (float64 on the host).  Any initial coefficients are valid, the
    adaptive walk tunes them from there; better ones shrink the packet."""
    x = np.asarray(samples, dtype=np.float64)
    n = x.shape[0]
    if n < order * 4 + 8:
        return None
    # Predict x[t] - top from lagged differences (the decoder's model:
    # prediction = top + sum(c_k * (x[t-1-k] - top)) / 2^den_shift).
    top = x[: n - order - 1]
    target = x[order + 1 :] - top
    A = np.stack([x[order - k : n - 1 - k] - top for k in range(order)], axis=1)
    try:
        sol, *_ = np.linalg.lstsq(A, target, rcond=None)
    except np.linalg.LinAlgError:
        return None
    q = np.clip(np.round(sol * (1 << den_shift)), -30000, 30000).astype(np.int64)
    return [int(v) for v in q]


@dataclass
class EncoderSpec:
    """Whole-stream encoding choices."""

    channel: ChannelSpec = field(default_factory=ChannelSpec)
    #: Per-element overrides: one ChannelSpec per bitstream element (the
    #: layout for C channels is element_layout(C)); None uses ``channel``
    #: for every element.
    elements: list | None = None
    mix_bits: int = 1
    mix_res: int = 1  # 0 disables stereo decorrelation
    bytes_shifted: int = 0  # 0..2; >0 moves low bytes to the shift region
    escape: bool = False  # force raw (uncompressed) elements
    auto_escape: bool = True  # pick escape when it is smaller (noise-like blocks)
    use_lfe_tag: bool = True  # tag the LFE channel as LFE instead of SCE

    def element_specs(self, num_channels: int) -> list[ChannelSpec]:
        """One ChannelSpec per bitstream element of a C-channel packet."""
        layout = element_layout(num_channels)
        specs = self.elements if self.elements is not None else [self.channel] * len(layout)
        if len(specs) != len(layout):
            raise ValueError(
                f"spec.elements has {len(specs)} entries; "
                f"{num_channels}-channel layout has {len(layout)} elements"
            )
        return list(specs)
