"""Minimal RIFF/WAVE read/write for integer PCM (the port's copy of
saprobe_alac_tpu/utils/wav.py).

Plays the role of the reference test-harness WAV helpers
(tests/testutil/alacconvert.go:119-182 and cmd main.go:136-169): a 44-byte
canonical header over interleaved little-endian signed PCM.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

from ..formats import PCMFormat, bytes_per_sample


def wav_header(fmt: PCMFormat, data_size: int) -> bytes:
    """The canonical 44-byte PCM WAV header (reference main.go:136-169)."""
    bps = bytes_per_sample(fmt.bit_depth)
    # Container bit width: 20-bit samples travel in 24-bit containers.
    container_bits = bps * 8
    byte_rate = fmt.sample_rate * fmt.channels * bps
    block_align = fmt.channels * bps
    return b"".join(
        [
            b"RIFF",
            struct.pack("<I", 36 + data_size),
            b"WAVE",
            b"fmt ",
            struct.pack("<IHHIIHH", 16, 1, fmt.channels, fmt.sample_rate, byte_rate, block_align, container_bits),
            b"data",
            struct.pack("<I", data_size),
        ]
    )


def write_wav(out: BinaryIO, fmt: PCMFormat, pcm: bytes) -> None:
    out.write(wav_header(fmt, len(pcm)))
    out.write(pcm)


def read_wav(reader: BinaryIO) -> tuple[PCMFormat, bytes]:
    """Parse a PCM WAV file; returns (format, raw interleaved PCM bytes)."""
    riff = reader.read(12)
    if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = None
    while True:
        hdr = reader.read(8)
        if len(hdr) < 8:
            raise ValueError("no data chunk found")
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fmt ":
            payload = reader.read(size)
            tag, channels, rate, _, _, bits = struct.unpack("<HHIIHH", payload[:16])
            if tag == 0xFFFE and len(payload) >= 26:
                # WAVE_FORMAT_EXTENSIBLE: the real format code leads the GUID.
                tag = struct.unpack("<H", payload[24:26])[0]
            if tag != 1:
                raise ValueError(f"unsupported WAV format tag {tag} (integer PCM only)")
            fmt = PCMFormat(sample_rate=rate, bit_depth=bits, channels=channels)
        elif cid == b"data":
            if fmt is None:
                raise ValueError("data chunk before fmt chunk")
            return fmt, reader.read(size)
        else:
            reader.read(size + (size & 1))
