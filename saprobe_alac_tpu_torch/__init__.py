"""saprobe_alac_tpu_torch — batched ALAC decode and encode in PyTorch and CUDA.

A port of saprobe_alac_tpu's `BatchDecoder.decode_packets` for 16-, 20-, 24-
and 32-bit mono and stereo streams (bytesShifted 0, 1 and 2), and of its
device encoder `encode_packets_device` (every layout C = 1..8).  The Pallas
kernels on those paths (element walk, LPC in both directions, shift-region
raw reader, Golomb-Rice encode) are hand-written CUDA kernels for Hopper
(csrc/, built with nvcc at first use); the glue around them is plain
PyTorch.  `BatchDecoder(cfg)` and `encode_packets_device(cfg, spec, pcms)`
run on the card; with ``"cpu"`` they run every kernel's plain PyTorch
version.  The host side (packing, host decode, host encoder) is the repo's
C++ core in native/, built with g++ at first use.  This package imports neither JAX
nor anything of saprobe_alac_tpu: it keeps its own copies of what it needs.
"""

from ._build import launch_counts, reset_launch_counts
from .config import PacketConfig
from .decoder import BatchDecoder
from .encoder import ChannelSpec, EncoderSpec, encode_packets
from .errors import (
    AlacError,
    BitstreamOverrun,
    ConfigError,
    DecodeError,
    InvalidHeader,
    InvalidShift,
    SampleOverrun,
    UnsupportedBitDepth,
    UnsupportedElement,
    UnsupportedSpec,
)
from .ops.batch import TorchBatchDecoder
from .ops.encode_device import encode_packets_device

__all__ = [
    "AlacError", "BatchDecoder", "BitstreamOverrun", "ChannelSpec", "ConfigError",
    "DecodeError", "EncoderSpec", "InvalidHeader", "InvalidShift", "PacketConfig",
    "SampleOverrun", "TorchBatchDecoder", "UnsupportedBitDepth", "UnsupportedElement",
    "UnsupportedSpec", "encode_packets", "encode_packets_device", "launch_counts",
    "reset_launch_counts",
]
