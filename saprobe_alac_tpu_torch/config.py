"""Stream configuration: the ALAC magic cookie and its parse.

The port's own copy of saprobe_alac_tpu/config.py: `PacketConfig` holds the
fields of ALACSpecificConfig (reference config.go:27-38) and hashes by
value, so it keys the corpus service's batch groups; `parse_magic_cookie`
reads the 24-byte big-endian config, skipping the legacy 'frma' and 'alac'
atom wrappers and rejecting compatibleVersion > 0 (config.go:51-67).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from .errors import InvalidCookie, UnsupportedVersion

_CONFIG_SIZE = 24
_ATOM_HEADER_SIZE = 12  # size(4) + type(4) + payload(4)
_LAYOUT = ">IBBBBBBHIII"


@dataclass(frozen=True)
class PacketConfig:
    frame_length: int
    bit_depth: int
    num_channels: int
    pb: int
    mb: int
    kb: int
    max_run: int
    max_frame_bytes: int
    avg_bit_rate: int
    sample_rate: int

    def to_cookie(self) -> bytes:
        """Serialize back to a bare 24-byte ALACSpecificConfig."""
        return struct.pack(
            _LAYOUT, self.frame_length, 0, self.bit_depth, self.pb, self.mb, self.kb,
            self.num_channels, self.max_run, self.max_frame_bytes, self.avg_bit_rate,
            self.sample_rate,
        )


def parse_magic_cookie(cookie: bytes) -> PacketConfig:
    """Parse an ALACSpecificConfig from a magic cookie, bare or behind the
    'frma' and 'alac' atoms."""
    data = cookie
    # 'frma' atom: [size:4][type:'frma'][format:'alac']
    if len(data) >= _ATOM_HEADER_SIZE and data[4:8] == b"frma":
        data = data[_ATOM_HEADER_SIZE:]
    # 'alac' atom header: [size:4][type:'alac'][version:4]
    if len(data) >= _ATOM_HEADER_SIZE and data[4:8] == b"alac":
        data = data[_ATOM_HEADER_SIZE:]
    if len(data) < _CONFIG_SIZE:
        raise InvalidCookie(f"magic cookie too short: {len(data)} bytes")
    if data[4] > 0:
        raise UnsupportedVersion(f"unsupported compatible version {data[4]}")
    (frame_length, _version, bit_depth, pb, mb, kb, num_channels, max_run, max_frame_bytes,
     avg_bit_rate, sample_rate) = struct.unpack(_LAYOUT, data[:_CONFIG_SIZE])
    return PacketConfig(
        frame_length=frame_length, bit_depth=bit_depth, num_channels=num_channels, pb=pb,
        mb=mb, kb=kb, max_run=max_run, max_frame_bytes=max_frame_bytes,
        avg_bit_rate=avg_bit_rate, sample_rate=sample_rate,
    )
