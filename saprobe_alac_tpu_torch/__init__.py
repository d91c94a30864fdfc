"""saprobe_alac_tpu_torch — ALAC decode and encode in PyTorch and CUDA.

A port of saprobe_alac_tpu to one NVIDIA card.  Its public surface is the
JAX package's: the streaming ``Decoder`` (`new_decoder`, `read`, `seek`,
`seek_exact`, `format`, `duration`, `position`) over M4A/MP4 and CAF files,
`decode_file`, the corpus service (`decode_corpus`, `iter_decode_corpus`),
`parse_magic_cookie`, `PacketDecoder` and the batch API
`BatchDecoder.decode_packets` for 16-, 20-, 24- and 32-bit streams of
C = 1..8 channels in every element layout, with packet-axis sharding over
every card (`ShardedBatchDecoder`, parallel/: one `TorchBatchDecoder` a
card); the encoder
(`encoder.encode_packets`, `encode_to_m4a`, `build_m4a`, `build_caf`); the
CLI (`python -m saprobe_alac_tpu_torch.cli`); the stage profiler
(utils/profiling.py) and audio features on the card (ops/audio.py).  Every Pallas kernel of
the JAX package (element walk, its multi-element packet walk, LPC in both
directions, shift-region raw reader, Golomb-Rice encode, and the parse-free
entropy walk `dense_entropy`) is a hand-written CUDA kernel for Hopper
(csrc/, built with nvcc at first use); the glue around them is plain
PyTorch.  Every entry point runs on the card and raises without one unless
the caller asks for ``"cpu"`` (every kernel's plain PyTorch version),
``"native"`` (the repo's C++ core in native/, built with g++ at first use,
which also packs batches and decodes the packets the card flags), or
``"scalar"`` (the Python oracle, codec/; ``"python"`` for the encoder).  This
package imports neither JAX nor anything of saprobe_alac_tpu: it keeps its
own copies of what it needs.
"""

from ._build import launch_counts, reset_launch_counts
from .caf import build_caf
from .config import PacketConfig, parse_magic_cookie
from .decode import Decoder, decode_file, demux_stream, new_decoder
from .decoder import BatchDecoder, PacketDecoder
from .encoder import ChannelSpec, EncoderSpec, encode_packets
from .errors import (
    AlacError,
    BitstreamOverrun,
    ConfigError,
    DecodeError,
    InvalidCookie,
    InvalidHeader,
    InvalidShift,
    NoTrackError,
    SampleOverrun,
    UnsupportedBitDepth,
    UnsupportedElement,
    UnsupportedSpec,
    UnsupportedVersion,
)
from .formats import ALAC_BIT_DEPTHS, PCMFormat, bytes_per_sample
from .ops.batch import TorchBatchDecoder
from .ops.encode_device import encode_packets_device
from .ops.walk_kernel import dense_entropy
from .parallel import ShardedBatchDecoder
from .service import DecodedFile, decode_corpus, iter_decode_corpus

__version__ = "0.1.0"

__all__ = [
    "ALAC_BIT_DEPTHS", "AlacError", "BatchDecoder", "BitstreamOverrun", "ChannelSpec",
    "ConfigError", "DecodeError", "DecodedFile", "Decoder", "EncoderSpec", "InvalidCookie",
    "InvalidHeader", "InvalidShift", "NoTrackError", "PCMFormat", "PacketConfig",
    "PacketDecoder", "SampleOverrun", "ShardedBatchDecoder", "TorchBatchDecoder",
    "UnsupportedBitDepth", "UnsupportedElement", "UnsupportedSpec", "UnsupportedVersion",
    "build_caf", "bytes_per_sample", "decode_corpus", "decode_file", "demux_stream",
    "dense_entropy", "encode_packets", "encode_packets_device", "iter_decode_corpus",
    "launch_counts", "new_decoder", "parse_magic_cookie", "reset_launch_counts",
]
