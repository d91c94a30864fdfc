"""Decode-side error classes of the port.

The port's own copy of the decode-side classes of saprobe_alac_tpu/errors.py
(reference errors.go:25-33, internal/alac/errors.go:25-32): the same names
and the same hierarchy, so callers catch a broad category (`ConfigError`,
`DecodeError`) or a narrow condition (`BitstreamOverrun`, ...).  The
container errors stay with the JAX package until the port reads containers.
"""

from __future__ import annotations


class AlacError(Exception):
    """Base class for all errors raised by this package."""


class ConfigError(AlacError):
    """Invalid or unsupported ALAC configuration."""


class DecodeError(AlacError):
    """Failure during packet decoding."""


class UnsupportedBitDepth(ConfigError):
    """Bit depth not in {16, 20, 24, 32}."""


class UnsupportedElement(DecodeError):
    """CCE/PCE element encountered (not supported by ALAC)."""


class InvalidHeader(DecodeError):
    """The 12 unused header bits were non-zero."""


class InvalidShift(DecodeError):
    """bytesShifted field was 3 (invalid)."""


class BitstreamOverrun(DecodeError):
    """Bit cursor ran past the end of the packet."""


class SampleOverrun(DecodeError):
    """Decoded sample count exceeds the frame buffer."""


#: The C++ host core's error codes (native/alac_core.cpp:28-35) and the class
#: the scalar oracle raises for each; any other nonzero code is a
#: `DecodeError`.
_CORE_ERRORS = {
    1: BitstreamOverrun,
    2: UnsupportedElement,
    3: InvalidHeader,
    4: InvalidShift,
    5: SampleOverrun,
}


def core_error(code: int) -> DecodeError:
    """The exception for a nonzero error code of the host core."""
    return _CORE_ERRORS.get(code, DecodeError)(f"packet rejected by the decoder (code {code})")
