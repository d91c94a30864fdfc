"""MSB-first bit writer for ALAC bitstream assembly (the port's copy of
saprobe_alac_tpu/encoder/bitwriter.py; the Python encoder writes with it)."""

from __future__ import annotations


class BitWriter:
    """Accumulates bits MSB-first into a bytes object."""

    def __init__(self) -> None:
        self._acc = 0  # bit accumulator (MSB side = oldest)
        self._nbits = 0
        self._out = bytearray()

    def write(self, value: int, numbits: int) -> None:
        """Append the low ``numbits`` bits of ``value`` (MSB-first)."""
        if numbits == 0:
            return
        value &= (1 << numbits) - 1
        self._acc = (self._acc << numbits) | value
        self._nbits += numbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._out.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_ones(self, count: int) -> None:
        self.write((1 << count) - 1, count)

    def byte_align(self) -> None:
        if self._nbits:
            self.write(0, 8 - self._nbits)

    @property
    def bit_length(self) -> int:
        return len(self._out) * 8 + self._nbits

    def getvalue(self) -> bytes:
        """Final byte string (zero-pads a trailing partial byte)."""
        if self._nbits:
            pad = 8 - self._nbits
            return bytes(self._out) + bytes([(self._acc << pad) & 0xFF])
        return bytes(self._out)
