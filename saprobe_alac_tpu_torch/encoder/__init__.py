"""ALAC encoding: packets on the card, on the CPU, by the C++ host core or
by the Python encoder, and the M4A and CAF files around them.

Counterpart of saprobe_alac_tpu/encoder/: `encode_packets` (backends
``"cuda"``, ``"cpu"``, ``"native"`` and ``"python"``), the Python encoder's
`encode_packet`, `encode_to_m4a` / `encode_wav_to_m4a`, and the muxer
`build_m4a` / `write_m4a`.
"""

from .api import encode_to_m4a, encode_wav_to_m4a, make_packet_config
from .encode import encode_packet, encode_packets
from .mux import build_m4a, write_m4a
from .spec import ChannelSpec, EncoderSpec

__all__ = [
    "ChannelSpec", "EncoderSpec", "build_m4a", "encode_packet", "encode_packets", "encode_to_m4a",
    "encode_wav_to_m4a", "make_packet_config", "write_m4a",
]
