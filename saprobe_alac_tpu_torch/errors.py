"""Error classes of the port.

The port's own copy of saprobe_alac_tpu/errors.py (reference
errors.go:25-33, internal/alac/errors.go:25-32, internal/mp4/errors.go:25-33):
the same names and the same hierarchy, so callers catch a broad category
(`ConfigError`, `NoTrackError`, `DecodeError`) or a narrow condition
(`BitstreamOverrun`, `NoStsz`, ...).  `UnsupportedSpec` is the port's own.
"""

from __future__ import annotations


class AlacError(Exception):
    """Base class for all errors raised by this package."""


class ConfigError(AlacError):
    """Invalid or unsupported ALAC configuration."""


class NoTrackError(AlacError):
    """No usable ALAC track was found in the container."""


class DecodeError(AlacError):
    """Failure during packet decoding."""


class InvalidCookie(ConfigError):
    """Magic cookie is too short or malformed."""


class UnsupportedVersion(ConfigError):
    """ALACSpecificConfig compatibleVersion > 0."""


class UnsupportedSpec(ConfigError):
    """An EncoderSpec that the C++ host encoder cannot express."""


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


class Mp4Error(NoTrackError):
    """Base class for MP4 container parse failures."""


class NoAlacTrack(Mp4Error):
    """No ALAC track found in the container."""


class InvalidSampleEntry(Mp4Error):
    """Malformed 'alac' sample entry in stsd."""


class InvalidBoxSize(Mp4Error):
    """Box size smaller than its header."""


class NoChunkOffset(Mp4Error):
    """Missing or invalid stco/co64 box."""


class NoStsc(Mp4Error):
    """Missing or invalid stsc box."""


class NoStsz(Mp4Error):
    """Missing or invalid stsz box."""


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
