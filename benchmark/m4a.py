"""The benchmark's M4A writer: a frozen copy of the port's
`saprobe_alac_tpu_torch/encoder/mux.py::build_m4a` and of
`PacketConfig.to_cookie` (config.py) at commit
98930b188f5672967c40f97b3a29693719e8f90a, taking a configuration file's
dict in place of a `PacketConfig`, writing only the standard cookie
layout, and writing the file without joining its packets in memory.
Nothing here imports the system under test.

The file: ftyp, then moov/trak/mdia/minf/stbl with an 'alac' sample entry
holding the magic cookie, stts/stsc/stsz/stco, then an mdat of the packets.
"""

from __future__ import annotations

import struct

#: ALACSpecificConfig: frame length, compatible version, bit depth, pb, mb,
#: kb, channels, max run, max frame bytes, average bit rate, sample rate.
_COOKIE = ">IBBBBBBHIII"


def _box(fourcc: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + fourcc + payload


def _full_box(fourcc: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(fourcc, struct.pack(">B3s", version, flags.to_bytes(3, "big")) + payload)


def cookie(config: dict) -> bytes:
    """The bare 24-byte ALACSpecificConfig of a configuration."""
    c = config
    return struct.pack(_COOKIE, c["frame_length"], 0, c["bit_depth"], c["pb"], c["mb"], c["kb"],
                       c["num_channels"], c["max_run"], c["max_frame_bytes"],
                       c["avg_bit_rate"], c["sample_rate"])


def _alac_sample_entry(config: dict) -> bytes:
    """AudioSampleEntry 'alac' with the cookie inside an 'alac' box."""
    body = struct.pack(
        ">6sHHHIHHHHI",
        b"\x00" * 6,
        1,  # data reference index
        0,  # QT version 0
        0,
        0,
        config["num_channels"],
        min(config["bit_depth"], 16) if config["bit_depth"] != 32 else 16,
        0,
        0,
        # The 16.16 rate caps at 65535; decoders take the rate from the cookie.
        min(config["sample_rate"], 0xFFFF) << 16,
    )
    c = cookie(config)
    return _box(b"alac", body + struct.pack(">I4sI", 12 + len(c), b"alac", 0) + c)


def write_m4a(path, config: dict, packets: list[bytes],
              samples_per_packet: list[int] | None = None) -> int:
    """Write the M4A file of the encoded packets to ``path`` (the bytes
    `build_m4a` returns, without joining the packets in memory); returns
    the file's size."""
    head = _head(config, packets, samples_per_packet)
    with open(path, "wb") as f:
        f.write(head)
        f.writelines(packets)
    return len(head) + sum(map(len, packets))


def _head(config: dict, packets: list[bytes], samples_per_packet: list[int] | None) -> bytes:
    """Everything before the packets: ftyp, moov and mdat's box header."""
    n = len(packets)
    if samples_per_packet is None:
        samples_per_packet = [config["frame_length"]] * n
    total_samples = sum(samples_per_packet)
    rate = config["sample_rate"]

    ftyp = _box(b"ftyp", b"M4A " + struct.pack(">I", 0) + b"M4A mp42isom")

    stts_entries = []  # runs of (count, delta)
    for spp in samples_per_packet:
        if stts_entries and stts_entries[-1][1] == spp:
            stts_entries[-1][0] += 1
        else:
            stts_entries.append([1, spp])
    stts = _full_box(b"stts", 0, 0, struct.pack(">I", len(stts_entries))
                     + b"".join(struct.pack(">II", c, d) for c, d in stts_entries))
    stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1) + _alac_sample_entry(config))
    stsc = _full_box(b"stsc", 0, 0, struct.pack(">I", 1) + struct.pack(">III", 1, n or 1, 1))
    stsz = _full_box(b"stsz", 0, 0, struct.pack(">II", 0, n)
                     + b"".join(struct.pack(">I", len(p)) for p in packets))

    # stco holds the mdat payload's absolute offset: size moov with a
    # placeholder, then build it again (the offset's width is fixed).
    def moov_bytes(mdat_offset: int) -> bytes:
        stco = _full_box(b"stco", 0, 0, struct.pack(">I", 1) + struct.pack(">I", mdat_offset))
        stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)
        url = _full_box(b"url ", 0, 1, b"")
        dref = _full_box(b"dref", 0, 0, struct.pack(">I", 1) + url)
        dinf = _box(b"dinf", dref)
        smhd = _full_box(b"smhd", 0, 0, struct.pack(">HH", 0, 0))
        minf = _box(b"minf", smhd + dinf + stbl)
        hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I4s4s", 0, b"soun", b"appl") + b"\x00" * 9)
        mdhd = _full_box(b"mdhd", 0, 0,
                         struct.pack(">IIIIHH", 0, 0, rate, total_samples, 0x55C4, 0))
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        tkhd = _full_box(
            b"tkhd", 0, 7,
            struct.pack(">IIIII", 0, 0, 1, 0, 0)
            + struct.pack(">II", 0, 0)
            + struct.pack(">HHHH", 0, 0, 0x0100, 0)
            + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
            + struct.pack(">II", 0, 0),
        )
        trak = _box(b"trak", tkhd + mdia)
        mvhd = _full_box(
            b"mvhd", 0, 0,
            struct.pack(">IIII", 0, 0, rate, total_samples)
            + struct.pack(">IH", 0x00010000, 0x0100)
            + b"\x00" * 10
            + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
            + b"\x00" * 24
            + struct.pack(">I", 2),
        )
        return _box(b"moov", mvhd + trak)

    probe = moov_bytes(0)
    mdat_offset = len(ftyp) + len(probe) + 8  # the payload follows mdat's header
    moov = moov_bytes(mdat_offset)
    assert len(moov) == len(probe)
    return ftyp + moov + struct.pack(">I", 8 + sum(map(len, packets))) + b"mdat"
