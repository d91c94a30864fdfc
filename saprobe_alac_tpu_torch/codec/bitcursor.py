"""Bit-level cursor over a packet byte buffer.

Scalar analogue of the reference BitBuffer (internal/alac/bitbuffer.go:25-123):
a monotone bit position over zero-padded packet bytes.  All reads are exact
right-aligned extractions; the zero padding makes reads near the end safe and
deterministic, matching the reference's 4-byte zero pad.
"""

from __future__ import annotations

_PAD = 8  # zero pad bytes; >= reference's 4, all padding reads are zeros either way


class BitCursor:
    """Readable bit cursor with snapshot support.

    ``bitpos`` is the absolute bit offset from the start of the packet.  The
    reference tracks (Pos bytes, BitIdx bits); bitpos = Pos*8 + BitIdx.
    """

    __slots__ = ("data", "bitpos", "size")

    def __init__(self, packet: bytes):
        self.data = bytes(packet) + b"\x00" * _PAD
        self.bitpos = 0
        self.size = len(packet)  # original byte size

    def read(self, numbits: int) -> int:
        """Read up to 32 bits, right-aligned (covers Read/ReadSmall/ReadOne).

        Reads past the zero pad deterministically return zeros: a short slice
        is left-justified back to 5 bytes (``int.from_bytes`` alone would
        right-align it, yielding misaligned garbage), matching the clamped
        native cursor (native/alac_core.cpp Cursor::clamp).
        """
        p = self.bitpos
        byteoff = p >> 3
        sh = p & 7
        win = self.data[byteoff : byteoff + 5]
        if len(win) < 5:
            win = win + b"\x00" * (5 - len(win))
        w = int.from_bytes(win, "big")  # 40-bit window
        self.bitpos = p + numbits
        return (w >> (40 - sh - numbits)) & ((1 << numbits) - 1)

    def advance(self, numbits: int) -> None:
        self.bitpos += numbits

    def byte_align(self) -> None:
        rem = self.bitpos & 7
        if rem:
            self.bitpos += 8 - rem

    def past_end(self) -> bool:
        """True when at/past the original data end (reference bitbuffer.go:115-117)."""
        return (self.bitpos >> 3) >= self.size

    def copy(self) -> "BitCursor":
        c = BitCursor.__new__(BitCursor)
        c.data = self.data
        c.bitpos = self.bitpos
        c.size = self.size
        return c


def window32(data: bytes, bitpos: int) -> int:
    """The 32 bits starting at ``bitpos`` (true stream bits, MSB-first).

    Where the reference computes ``read32bit(buf, bitPos>>3) << (bitPos&7)``
    (a 32-bit window whose low bitPos&7 bits are zero-filled), this returns the
    true stream bits.  Equivalent for every use: decode consumes at most 25 of
    the top bits, which are identical in both forms (see golomb.py analysis).
    """
    byteoff = bitpos >> 3
    sh = bitpos & 7
    win = data[byteoff : byteoff + 5]
    if len(win) < 5:  # past the pad: left-justify so overreads are zeros
        win = win + b"\x00" * (5 - len(win))
    w = int.from_bytes(win, "big")
    return (w >> (8 - sh)) & 0xFFFFFFFF


def get_stream_bits(data: bytes, bitpos: int, numbits: int) -> int:
    """Read ``numbits`` (1..33) at an arbitrary bit position, Go semantics.

    Mirrors reference getStreamBits (golomb.go:86-108) including the numbits=33
    corner where Go's saturating shifts zero the high part (possible when
    chanBits = 32-bit depth + 1 CPE decorrelation bit with no byte shift).
    """
    if numbits <= 32:
        return window32(data, bitpos) >> (32 - numbits) if numbits < 32 else window32(data, bitpos)
    # numbits == 33, replicating Go: result = (load1 << b) >> (32-33) -> 0,
    # then |= 5th byte >> (7-b): only the low b+1 bits survive.
    byteoff = bitpos >> 3
    b = bitpos & 7
    fifth = data[byteoff + 4] if byteoff + 4 < len(data) else 0
    return fifth >> (7 - b)
