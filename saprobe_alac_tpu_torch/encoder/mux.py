"""Minimal MP4/M4A muxer for ALAC streams (the port's copy of
saprobe_alac_tpu/encoder/mux.py, byte for byte the same files).

Produces the box structure the demuxer (mp4/demux.py) and the reference
demuxer (internal/mp4/mp4.go:233-420) consume: moov/trak/mdia/minf/stbl with
an 'alac' sample entry carrying the magic cookie, plus stts/stsc/stsz/stco and
an mdat holding the packets.
"""

from __future__ import annotations

import struct

from ..config import PacketConfig


def _box(fourcc: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + fourcc + payload


def _full_box(fourcc: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(fourcc, struct.pack(">B3s", version, flags.to_bytes(3, "big")) + payload)


def _alac_sample_entry(config: PacketConfig, wrap_cookie: bool = False) -> bytes:
    """AudioSampleEntry 'alac' with the ALACSpecificConfig cookie.

    ``wrap_cookie`` adds the legacy 'frma'+'alac' atom wrappers that
    parse_magic_cookie must skip (reference config.go:51-58).
    """
    cookie = config.to_cookie()
    if wrap_cookie:
        frma = struct.pack(">I4s4s", 12, b"frma", b"alac")
        alac_hdr = struct.pack(">I4sI", 12 + len(cookie), b"alac", 0)
        cookie_payload = frma + alac_hdr + cookie
    else:
        # Standard layout: cookie inside an 'alac' box (ISO esds-style wrapper).
        cookie_payload = struct.pack(">I4sI", 12 + len(cookie), b"alac", 0) + cookie

    # AudioSampleEntry: reserved(6) + dataRefIdx(2) + version(2) + revision(2)
    # + vendor(4) + channels(2) + sampleSize(2) + compressionID(2) + packetSize(2)
    # + sampleRate(4, 16.16 fixed)  == 28 bytes after the 8-byte box header.
    body = struct.pack(
        ">6sHHHIHHHHI",
        b"\x00" * 6,
        1,  # data reference index
        0,  # QT version 0
        0,
        0,
        config.num_channels,
        min(config.bit_depth, 16) if config.bit_depth != 32 else 16,
        0,
        0,
        # QT 16.16 fixed-point rate caps at 65535; decoders take the true rate
        # from the ALAC cookie (reference decode.go:56), so clamping is fine.
        min(config.sample_rate, 0xFFFF) << 16,
    )
    return _box(b"alac", body + cookie_payload)


def build_m4a(
    config: PacketConfig,
    packets: list[bytes],
    samples_per_packet: list[int] | None = None,
    wrap_cookie: bool = False,
) -> bytes:
    """Assemble a complete M4A file from encoded packets."""
    n = len(packets)
    if samples_per_packet is None:
        samples_per_packet = [config.frame_length] * n
    total_samples = sum(samples_per_packet)

    ftyp = _box(b"ftyp", b"M4A " + struct.pack(">I", 0) + b"M4A mp42isom")

    mdat_payload = b"".join(packets)

    # stts: runs of (count, delta).
    stts_entries = []
    for spp in samples_per_packet:
        if stts_entries and stts_entries[-1][1] == spp:
            stts_entries[-1][0] += 1
        else:
            stts_entries.append([1, spp])
    stts = _full_box(
        b"stts",
        0,
        0,
        struct.pack(">I", len(stts_entries))
        + b"".join(struct.pack(">II", c, d) for c, d in stts_entries),
    )

    stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1) + _alac_sample_entry(config, wrap_cookie))
    stsc = _full_box(b"stsc", 0, 0, struct.pack(">I", 1) + struct.pack(">III", 1, n or 1, 1))
    stsz = _full_box(
        b"stsz",
        0,
        0,
        struct.pack(">II", 0, n) + b"".join(struct.pack(">I", len(p)) for p in packets),
    )

    # stco needs the absolute mdat payload offset; compute moov size with a
    # placeholder then patch (sizes don't change since the offset width is fixed).
    def moov_bytes(mdat_offset: int) -> bytes:
        stco = _full_box(b"stco", 0, 0, struct.pack(">I", 1) + struct.pack(">I", mdat_offset))
        stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)
        url = _full_box(b"url ", 0, 1, b"")
        dref = _full_box(b"dref", 0, 0, struct.pack(">I", 1) + url)
        dinf = _box(b"dinf", dref)
        smhd = _full_box(b"smhd", 0, 0, struct.pack(">HH", 0, 0))
        minf = _box(b"minf", smhd + dinf + stbl)
        hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I4s4s", 0, b"soun", b"appl") + b"\x00" * 9)
        mdhd = _full_box(
            b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, config.sample_rate, total_samples, 0x55C4, 0)
        )
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        tkhd = _full_box(
            b"tkhd",
            0,
            7,
            struct.pack(">IIIII", 0, 0, 1, 0, 0)
            + struct.pack(">II", 0, 0)
            + struct.pack(">HHHH", 0, 0, 0x0100, 0)
            + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
            + struct.pack(">II", 0, 0),
        )
        trak = _box(b"trak", tkhd + mdia)
        mvhd = _full_box(
            b"mvhd",
            0,
            0,
            struct.pack(">IIII", 0, 0, config.sample_rate, total_samples)
            + struct.pack(">IH", 0x00010000, 0x0100)
            + b"\x00" * 10
            + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
            + b"\x00" * 24
            + struct.pack(">I", 2),
        )
        return _box(b"moov", mvhd + trak)

    probe = moov_bytes(0)
    mdat_offset = len(ftyp) + len(probe) + 8  # mdat payload starts after its header
    moov = moov_bytes(mdat_offset)
    assert len(moov) == len(probe)
    mdat = _box(b"mdat", mdat_payload)
    return ftyp + moov + mdat


def write_m4a(
    path: str,
    config: PacketConfig,
    packets: list[bytes],
    samples_per_packet: list[int] | None = None,
    wrap_cookie: bool = False,
) -> None:
    with open(path, "wb") as f:
        f.write(build_m4a(config, packets, samples_per_packet, wrap_cookie))
