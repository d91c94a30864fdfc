"""High-level encoding API: PCM arrays or WAV files -> ALAC M4A or CAF.

Counterpart of saprobe_alac_tpu/encoder/api.py over the port's
`encode_packets` and its backend words: ``"cuda"`` (default), ``"cpu"``,
``"native"`` (the C++ core) and ``"python"``.
"""

from __future__ import annotations

from typing import BinaryIO

import numpy as np

from ..caf import build_caf
from ..config import PacketConfig
from ..formats import PCMFormat
from ..utils.pcmconv import pcm_bytes_to_array
from ..utils.wav import read_wav
from .encode import encode_packets
from .mux import build_m4a
from .spec import EncoderSpec

#: Apple-standard entropy tuning (the values Apple's encoder writes into
#: every cookie).
DEFAULT_PB = 40
DEFAULT_MB = 10
DEFAULT_KB = 14
DEFAULT_MAX_RUN = 255
DEFAULT_FRAME_LENGTH = 4096


def make_packet_config(fmt: PCMFormat, frame_length: int = DEFAULT_FRAME_LENGTH,
                       max_frame_bytes: int = 0, avg_bit_rate: int = 0) -> PacketConfig:
    return PacketConfig(
        frame_length=frame_length, bit_depth=fmt.bit_depth, num_channels=fmt.channels,
        pb=DEFAULT_PB, mb=DEFAULT_MB, kb=DEFAULT_KB, max_run=DEFAULT_MAX_RUN,
        max_frame_bytes=max_frame_bytes, avg_bit_rate=avg_bit_rate, sample_rate=fmt.sample_rate,
    )


def encode_to_m4a(fmt: PCMFormat, samples: np.ndarray, frame_length: int = DEFAULT_FRAME_LENGTH,
                  spec: EncoderSpec | None = None, container: str = "m4a",
                  backend="cuda") -> bytes:
    """Encode (n, channels) integer samples into an M4A or CAF file."""
    config = make_packet_config(fmt, frame_length=frame_length)
    packets = encode_packets(config, spec or EncoderSpec(), samples, backend=backend)
    n = samples.shape[0]
    spp = [min(frame_length, n - i * frame_length) for i in range(len(packets))]
    if container == "caf":
        return build_caf(config, packets, spp)
    return build_m4a(config, packets, spp)


def encode_wav_to_m4a(wav: BinaryIO, frame_length: int = DEFAULT_FRAME_LENGTH,
                      spec: EncoderSpec | None = None, container: str = "m4a",
                      backend="cuda") -> bytes:
    """Encode a PCM WAV stream into an ALAC M4A (or CAF) file."""
    fmt, data = read_wav(wav)
    return encode_to_m4a(fmt, pcm_bytes_to_array(fmt, data), frame_length=frame_length,
                         spec=spec, container=container, backend=backend)
