"""saprobe_alac_tpu_torch — the batched ALAC decode path in PyTorch and CUDA.

A port of saprobe_alac_tpu's `BatchDecoder.decode_packets` for 16-bit mono
and stereo streams.  The two Pallas kernels on that path are hand-written
CUDA kernels for Hopper (csrc/, built with nvcc at first use); the glue
around them is plain PyTorch.  On a CPU device every kernel runs its plain
PyTorch version.  The host side (packing, host decode, fixture encoder) is
the repo's C++ core in native/, built with g++ at first use.  This package
never imports JAX, and imports nothing of saprobe_alac_tpu except its
scalar oracle, and that only to raise the typed error of a malformed packet.
"""

from ._build import launch_counts, reset_launch_counts
from .config import PacketConfig
from .decoder import BatchDecoder
from .ops.batch import TorchBatchDecoder

__all__ = [
    "BatchDecoder", "PacketConfig", "TorchBatchDecoder", "launch_counts",
    "reset_launch_counts",
]
