"""CAF (Core Audio Format) container support for ALAC streams (the port's
copy of saprobe_alac_tpu/caf.py).

The reference supports only MP4/M4A (README.md:32-36 explicitly excludes
CAF); Apple's own `alacconvert` tool produces CAF, so this framework adds
both demux and mux.  CAF layout (Apple "Core Audio Format Specification"):

  'caff' file header (version 1, flags 0), then chunks:
    'desc' — AudioStreamBasicDescription (float64 rate, format 'alac', ...)
    'kuki' — the magic cookie (raw ALACSpecificConfig or wrapped)
    'pakt' — packet table header + variable-length (VLQ) packet sizes
    'data' — leading edit-count u32, then the packet bytes

All multi-byte fields are big-endian.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

from .config import PacketConfig
from .errors import NoAlacTrack
from .mp4 import SampleInfo


def _read_chunks(reader: BinaryIO) -> dict[bytes, tuple[int, int]]:
    """Map chunk type -> (payload offset, payload size)."""
    reader.seek(0)
    header = reader.read(8)
    if len(header) < 8 or header[:4] != b"caff":
        raise NoAlacTrack("not a CAF file")
    file_end = reader.seek(0, 2)
    reader.seek(8)

    chunks: dict[bytes, tuple[int, int]] = {}
    while True:
        pos = reader.tell()
        if pos >= file_end:
            break
        hdr = reader.read(12)
        if len(hdr) < 12:
            break
        ctype = hdr[:4]
        size = struct.unpack(">q", hdr[4:])[0]
        if size == -1:  # audio data chunk extends to EOF
            size = file_end - pos - 12
        if size < 0:  # malformed; also guards the walker's forward progress
            raise NoAlacTrack(f"CAF chunk {ctype!r} has invalid size {size}")
        # Clamp declared sizes to what the file can actually hold so a
        # malformed multi-gigabyte kuki/pakt size never triggers a huge read.
        size = min(size, file_end - pos - 12)
        if ctype not in chunks:  # first wins (spec: one desc/kuki/pakt)
            chunks[ctype] = (pos + 12, size)
        reader.seek(pos + 12 + size)
    return chunks


def find_alac_track_caf(reader: BinaryIO) -> tuple[bytes, list[SampleInfo]]:
    """CAF counterpart of mp4.find_alac_track: (cookie, flat sample table)."""
    chunks = _read_chunks(reader)

    if b"desc" not in chunks or b"kuki" not in chunks or b"data" not in chunks:
        raise NoAlacTrack("CAF file missing desc/kuki/data chunks")

    off, size = chunks[b"desc"]
    reader.seek(off)
    desc = reader.read(min(size, 32))
    if len(desc) < 32:
        raise NoAlacTrack("short CAF desc chunk")
    fmt_id = desc[8:12]
    if fmt_id != b"alac":
        raise NoAlacTrack(f"CAF stream format {fmt_id!r} is not ALAC")
    # NB: the desc frames-per-packet field is not validated here; the kuki
    # cookie's frame_length is the decode-authoritative value.

    off, size = chunks[b"kuki"]
    reader.seek(off)
    cookie = reader.read(size)

    data_off, data_size = chunks[b"data"]
    data_start = data_off + 4  # skip the u32 edit count

    if b"pakt" in chunks:
        off, size = chunks[b"pakt"]
        reader.seek(off)
        payload = reader.read(size)
        if len(payload) < 24:
            raise NoAlacTrack("short CAF pakt chunk")
        num_packets = struct.unpack(">q", payload[:8])[0]
        if num_packets < 0:
            raise NoAlacTrack(f"CAF pakt declares {num_packets} packets")
        sizes = []
        pos = 24  # header: numPackets q, numValidFrames q, priming i, remainder i
        end = len(payload)
        for _ in range(num_packets):
            val = 0
            while True:
                if pos >= end:
                    raise NoAlacTrack("CAF pakt table truncated")
                b = payload[pos]
                pos += 1
                val = (val << 7) | (b & 0x7F)
                if not b & 0x80:
                    break
            sizes.append(val)
        samples = []
        offset = data_start
        for s in sizes:
            samples.append(SampleInfo(offset=offset, size=s))
            offset += s
    else:
        # Constant-bytes-per-packet streams carry no pakt; ALAC is variable
        # so a missing table is malformed.
        raise NoAlacTrack("CAF ALAC stream missing pakt chunk")

    return cookie, samples


def build_caf(
    config: PacketConfig,
    packets: list[bytes],
    samples_per_packet: list[int] | None = None,
) -> bytes:
    """Assemble a CAF file from encoded ALAC packets."""
    if samples_per_packet is None:
        samples_per_packet = [config.frame_length] * len(packets)
    valid_frames = sum(samples_per_packet)

    out = bytearray()
    out += b"caff" + struct.pack(">HH", 1, 0)

    # desc: rate f64, fmt 'alac', flags u32, bytes/packet u32 (0=variable),
    # frames/packet u32, channels u32, bits u32 (0 for compressed).
    desc = struct.pack(
        ">d4sIIIII",
        float(config.sample_rate),
        b"alac",
        0,
        0,
        config.frame_length,
        config.num_channels,
        0,
    )
    out += b"desc" + struct.pack(">q", len(desc)) + desc

    cookie = config.to_cookie()
    out += b"kuki" + struct.pack(">q", len(cookie)) + cookie

    # pakt: header + VLQ sizes.
    vlq = bytearray()
    for p in packets:
        n = len(p)
        enc = [n & 0x7F]
        n >>= 7
        while n:
            enc.append(0x80 | (n & 0x7F))
            n >>= 7
        vlq += bytes(reversed(enc))
    pakt = struct.pack(">qqii", len(packets), valid_frames, 0, 0) + bytes(vlq)
    out += b"pakt" + struct.pack(">q", len(pakt)) + pakt

    payload = b"".join(packets)
    out += b"data" + struct.pack(">q", 4 + len(payload)) + struct.pack(">I", 0) + payload
    return bytes(out)


def sniff_container(reader: BinaryIO) -> str:
    """'caf', 'mp4', or 'unknown' from the leading bytes."""
    reader.seek(0)
    head = reader.read(12)
    reader.seek(0)
    if head[:4] == b"caff":
        return "caf"
    if len(head) >= 12 and head[4:8] in (b"ftyp", b"moov", b"mdat", b"free", b"wide", b"skip"):
        return "mp4"
    return "unknown"
