"""saprobe_alac_tpu_torch — the batched ALAC decode path in PyTorch and CUDA.

A port of saprobe_alac_tpu's `BatchDecoder.decode_packets` for 16-, 20-, 24-
and 32-bit mono and stereo streams (bytesShifted 0, 1 and 2).  The three
Pallas kernels on that path (element walk, LPC, shift-region raw reader) are
hand-written CUDA kernels for Hopper (csrc/, built with nvcc at first use);
the glue around them is plain PyTorch.  `BatchDecoder(cfg)` runs on the
card; `BatchDecoder(cfg, "cpu")` runs every kernel's plain PyTorch version.
The host side (packing, host decode, fixture encoder) is the repo's C++ core
in native/, built with g++ at first use.  This package imports neither JAX
nor anything of saprobe_alac_tpu: it keeps its own copies of what it needs.
"""

from ._build import launch_counts, reset_launch_counts
from .config import PacketConfig
from .decoder import BatchDecoder
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
)
from .ops.batch import TorchBatchDecoder

__all__ = [
    "AlacError", "BatchDecoder", "BitstreamOverrun", "ConfigError", "DecodeError",
    "InvalidHeader", "InvalidShift", "PacketConfig", "SampleOverrun", "TorchBatchDecoder",
    "UnsupportedBitDepth", "UnsupportedElement", "launch_counts", "reset_launch_counts",
]
