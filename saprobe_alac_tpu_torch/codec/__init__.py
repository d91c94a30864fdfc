"""Scalar (host, NumPy/Python) ALAC codec core: the port's own copy of
saprobe_alac_tpu/codec/.

The bit-exact oracle for the device path: an independent implementation of
the ALAC decode math (adaptive Golomb-Rice entropy coding, adaptive LPC
prediction, stereo un-decorrelation) with Go/C fixed-width integer
semantics.  ``backend="scalar"`` decodes through it, and the batch decoder
re-runs a packet the C++ host core rejects through it, so the packet raises
the oracle's typed exception.

Reference behavior: internal/alac/{bitbuffer,golomb,predictor,matrix}.go and
decoder.go in mycophonic/saprobe-alac.
"""

from .bitcursor import BitCursor
from .element import decode_packet

__all__ = ["BitCursor", "decode_packet"]
