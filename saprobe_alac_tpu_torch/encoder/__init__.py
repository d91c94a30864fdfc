"""Packet encoding: the device encoder and the C++ host encoder.

Counterpart of saprobe_alac_tpu/encoder/encode.py `encode_packets`
(encode.py:563-602) for the backends the port has: ``"device"`` (the
lane-parallel encoder of ops/encode_device.py, on the card unless the caller
asks for the CPU) and ``"native"`` (the repo's C++ core through
``native.encode_with_spec``).
"""

from __future__ import annotations

import numpy as np

from ..config import PacketConfig
from .spec import ChannelSpec, EncoderSpec

__all__ = ["ChannelSpec", "EncoderSpec", "encode_packets"]


def encode_packets(config: PacketConfig, spec: EncoderSpec, pcm: np.ndarray,
                   backend: str = "device", device="cuda") -> list[bytes]:
    """Encode (total_samples, channels) PCM into packets of ``frame_length``
    samples, the last one partial.  The two backends write the same format
    and, given the same initial coefficients, the same bytes; with fitting
    on, the device fits in float32 and the host core in float64, so their
    packets may differ in size and both decode to the source."""
    frame = config.frame_length
    chunks = [pcm[start : start + frame] for start in range(0, pcm.shape[0], frame)]
    if backend == "device":
        from ..ops.encode_device import encode_packets_device

        return encode_packets_device(config, spec, chunks, device=device)
    if backend == "native":
        from .. import native

        return native.encode_with_spec(config, spec, chunks)
    raise ValueError(f"unknown encoder backend {backend!r}")
