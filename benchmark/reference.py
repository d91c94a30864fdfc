"""The plain reference that decides `correct`, and its control.

ALAC is lossless, so the right decode of a packet is the PCM it was encoded
from, written as the decoder writes it (`inputs.pcm_bytes`): the reference
works every expected byte out again from the seeded source PCM, never from
anything the system under test made.  Plain NumPy; nothing here imports the
system under test.

The number compared has the limit 0: one differing, missing or extra byte
makes a run not correct.  The control is the reference one bit below the
precision the configuration states (the source with its lowest bit cleared):
it breaks the configuration's guarantee, bit-exact output, and has to come
out as not correct.
"""

from __future__ import annotations

import numpy as np

from .inputs import pcm_bytes

#: Each number compared and its limit.
LIMITS = {"bad_bytes": 0}
#: Bytes a sample takes in the decoder's output, by bit depth.
BYTES_PER_SAMPLE = {16: 2, 20: 3, 24: 3, 32: 4}


def lower_precision(pcm: np.ndarray) -> np.ndarray:
    """The control's source: one bit less, the lowest bit cleared."""
    return (pcm >> 1) << 1


def packet_bytes(config: dict, pcm: np.ndarray) -> list[bytes]:
    """The expected output of each packet of an encoded track: its slice of
    the source, the last one partial."""
    whole = pcm_bytes(pcm, config["bit_depth"])
    per = len(whole) // max(len(pcm), 1) * config["frame_length"]
    return [whole[s : s + per] for s in range(0, len(whole), per)]


def differing(got: bytes | None, want: bytes) -> int:
    """Bytes of ``got`` that differ from ``want``, counting what is missing
    or extra as differing."""
    if got is None:
        return len(want)
    if got == want:
        return 0
    n = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, n)
    b = np.frombuffer(want, np.uint8, n)
    return int(np.count_nonzero(a != b)) + abs(len(got) - len(want))
