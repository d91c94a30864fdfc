"""MP4/M4A box walking and ALAC track extraction (the port's copy of
saprobe_alac_tpu/mp4/demux.py).

Behavioral parity with reference internal/mp4/mp4.go: a generic box walker
(32-bit, 64-bit extended, and size-0 to-EOF boxes), 'alac' sample-entry cookie
extraction (QuickTime v0/v1 layouts), and a flat sample table built from
stco/co64 + stsc + stsz.  Demux stays on the host and feeds packet
windows to the card (SURVEY §2.2).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Callable, Iterator

from ..errors import (
    InvalidBoxSize,
    InvalidSampleEntry,
    NoAlacTrack,
    NoChunkOffset,
    NoStsc,
    NoStsz,
)

_SMALL_HEADER = 8
_LARGE_HEADER = 16
_FULL_BOX = 4  # version(1) + flags(3)


@dataclass(frozen=True)
class SampleInfo:
    """Byte offset and size of one encoded ALAC packet (mp4.go:29-32)."""

    offset: int
    size: int


@dataclass
class _BoxInfo:
    offset: int
    size: int
    header_size: int
    fourcc: bytes

    @property
    def payload_offset(self) -> int:
        return self.offset + self.header_size

    @property
    def payload_size(self) -> int:
        return self.size - self.header_size

    @property
    def end(self) -> int:
        return self.offset + self.size


def _read_box_info(reader: BinaryIO) -> _BoxInfo | None:
    """Read one box header at the current position; None at clean EOF."""
    offset = reader.tell()
    header = reader.read(_SMALL_HEADER)
    if len(header) < _SMALL_HEADER:
        return None

    raw_size = struct.unpack(">I", header[:4])[0]
    fourcc = header[4:8]
    header_size = _SMALL_HEADER

    if raw_size == 0:
        # Box extends to end of file.
        end = reader.seek(0, 2)
        size = end - offset
        reader.seek(offset + header_size)
    elif raw_size == 1:
        ext = reader.read(8)
        if len(ext) < 8:
            return None
        header_size = _LARGE_HEADER
        size = struct.unpack(">Q", ext)[0]
    else:
        size = raw_size

    if size < header_size:
        raise InvalidBoxSize(f"box size {size} at offset {offset}")

    return _BoxInfo(offset=offset, size=size, header_size=header_size, fourcc=fourcc)


def _iter_children(reader: BinaryIO, parent: _BoxInfo) -> Iterator[_BoxInfo]:
    reader.seek(parent.payload_offset)
    end = parent.end
    while True:
        pos = reader.tell()
        if pos >= end:
            return
        child = _read_box_info(reader)
        if child is None:
            return
        yield child
        reader.seek(child.end)


def _find_child(reader: BinaryIO, parent: _BoxInfo, fourcc: bytes) -> _BoxInfo | None:
    for child in _iter_children(reader, parent):
        if child.fourcc == fourcc:
            return child
    return None


def _find_descendant(reader: BinaryIO, parent: _BoxInfo, path: list[bytes]) -> _BoxInfo | None:
    current = parent
    for fourcc in path:
        child = _find_child(reader, current, fourcc)
        if child is None:
            return None
        current = child
    return current


def find_alac_track(reader: BinaryIO) -> tuple[bytes, list[SampleInfo]]:
    """Locate the first ALAC track; returns (magic cookie, flat sample table).

    Parity with reference FindALACTrack (mp4.go:233-300).
    """
    reader.seek(0)
    file_end = reader.seek(0, 2)
    root = _BoxInfo(offset=0, size=file_end, header_size=0, fourcc=b"")

    moov = _find_child(reader, root, b"moov")
    if moov is None:
        raise NoAlacTrack("no moov box")

    for trak in _iter_children(reader, moov):
        if trak.fourcc != b"trak":
            continue
        stbl = _find_descendant(reader, trak, [b"mdia", b"minf", b"stbl"])
        if stbl is None:
            continue
        try:
            cookie = _extract_cookie(reader, stbl)
        except NoAlacTrack:
            continue  # not an ALAC track; try the next trak
        samples = _build_sample_table(reader, stbl)
        return cookie, samples

    raise NoAlacTrack("no ALAC track found in container")


_SAMPLE_ENTRY_HEADER = 8
_SAMPLE_ENTRY_BASE = 28
_SAMPLE_ENTRY_V1_EXTRA = 16
_STSD_PAYLOAD_HEADER = 8


def _extract_cookie(reader: BinaryIO, stbl: _BoxInfo) -> bytes:
    """Find the 'alac' sample entry in stsd and return its cookie bytes
    (possibly still wrapped in 'frma'/'alac' atoms; parse_magic_cookie
    unwraps).  Parity with mp4.go:313-378 including QT v1 layouts.
    """
    stsd = _find_child(reader, stbl, b"stsd")
    if stsd is None:
        raise NoAlacTrack("no stsd box")

    reader.seek(stsd.payload_offset)
    data = reader.read(stsd.payload_size)
    if len(data) < _STSD_PAYLOAD_HEADER:
        raise NoAlacTrack("short stsd payload")

    entry_count = struct.unpack(">I", data[4:8])[0]
    pos = _STSD_PAYLOAD_HEADER

    for _ in range(entry_count):
        if pos + _SAMPLE_ENTRY_HEADER > len(data):
            break
        entry_size = struct.unpack(">I", data[pos : pos + 4])[0]
        if entry_size < _SAMPLE_ENTRY_HEADER:
            break  # malformed size can't advance; stop instead of spinning
        if entry_size < _SAMPLE_ENTRY_HEADER + _SAMPLE_ENTRY_BASE or pos + entry_size > len(data):
            pos += entry_size
            continue
        if data[pos + 4 : pos + 8] != b"alac":
            pos += entry_size
            continue

        # Found the ALAC entry; QT version decides the cookie offset.
        version = struct.unpack(
            ">H", data[pos + _SAMPLE_ENTRY_HEADER + 8 : pos + _SAMPLE_ENTRY_HEADER + 10]
        )[0]
        skip = _SAMPLE_ENTRY_HEADER + _SAMPLE_ENTRY_BASE
        if version == 1:
            skip += _SAMPLE_ENTRY_V1_EXTRA

        start = pos + skip
        end = pos + entry_size
        if start >= end:
            raise InvalidSampleEntry("empty ALAC sample entry")
        return data[start:end]

    raise NoAlacTrack("no 'alac' sample entry in stsd")


def _build_sample_table(reader: BinaryIO, stbl: _BoxInfo) -> list[SampleInfo]:
    """Flatten stco/co64 + stsc + stsz into per-packet (offset, size)
    (mp4.go:382-420)."""
    chunk_offsets = _read_chunk_offsets(reader, stbl)
    stsc_entries = _read_stsc(reader, stbl)
    entry_sizes, constant_size, sample_count = _read_stsz(reader, stbl)

    samples: list[SampleInfo] = []
    sample_idx = 0
    for chunk_idx, chunk_offset in enumerate(chunk_offsets):
        per_chunk = _samples_per_chunk(stsc_entries, chunk_idx + 1)  # 1-based
        offset = chunk_offset
        for _ in range(per_chunk):
            if sample_idx >= sample_count:
                break
            size = constant_size if constant_size else entry_sizes[sample_idx]
            samples.append(SampleInfo(offset=offset, size=size))
            offset += size
            sample_idx += 1

    return samples


def _read_full_box_table(
    reader: BinaryIO, box: _BoxInfo, entry_size: int, error: Callable[[str], Exception]
) -> bytes:
    reader.seek(box.payload_offset)
    header = reader.read(_FULL_BOX + 4)
    if len(header) < _FULL_BOX + 4:
        raise error("short box header")
    count = struct.unpack(">I", header[_FULL_BOX:])[0]
    data = reader.read(count * entry_size)
    if len(data) < count * entry_size:
        raise error("short box payload")
    return data


def _read_chunk_offsets(reader: BinaryIO, stbl: _BoxInfo) -> list[int]:
    stco = _find_child(reader, stbl, b"stco")
    if stco is not None:
        data = _read_full_box_table(reader, stco, 4, NoChunkOffset)
        return [x[0] for x in struct.iter_unpack(">I", data)]
    co64 = _find_child(reader, stbl, b"co64")
    if co64 is None:
        raise NoChunkOffset("no stco/co64 box")
    data = _read_full_box_table(reader, co64, 8, NoChunkOffset)
    return [x[0] for x in struct.iter_unpack(">Q", data)]


def _read_stsc(reader: BinaryIO, stbl: _BoxInfo) -> list[tuple[int, int]]:
    box = _find_child(reader, stbl, b"stsc")
    if box is None:
        raise NoStsc("no stsc box")
    data = _read_full_box_table(reader, box, 12, NoStsc)
    return [(first, per) for first, per, _ in struct.iter_unpack(">III", data)]


def _read_stsz(reader: BinaryIO, stbl: _BoxInfo) -> tuple[list[int], int, int]:
    box = _find_child(reader, stbl, b"stsz")
    if box is None:
        raise NoStsz("no stsz box")
    reader.seek(box.payload_offset)
    header = reader.read(_FULL_BOX + 8)
    if len(header) < _FULL_BOX + 8:
        raise NoStsz("short stsz header")
    sample_size, sample_count = struct.unpack(">II", header[_FULL_BOX:])
    if sample_size != 0:
        return [], sample_size, sample_count
    data = reader.read(sample_count * 4)
    if len(data) < sample_count * 4:
        raise NoStsz("short stsz payload")
    return [x[0] for x in struct.iter_unpack(">I", data)], 0, sample_count


def _samples_per_chunk(entries: list[tuple[int, int]], chunk_number: int) -> int:
    """Run-length stsc lookup (mp4.go:579-591)."""
    per = 0
    for first, samples in entries:
        if first > chunk_number:
            break
        per = samples
    return per
