"""Command-line M4A/CAF -> WAV/PCM decoder and WAV -> M4A/CAF encoder.

Counterpart of saprobe_alac_tpu/cli.py (reference
cmd/alac-example-decoder/main.go):

  python -m saprobe_alac_tpu_torch.cli [-version] [-format wav|pcm]
      [-backend cuda|cpu|native|scalar] [-batch N] <in.m4a|in.caf|-> [out]

``-backend`` picks where windows decode: ``cuda`` (default; raises without
a card), ``cpu`` (the kernels' plain versions), ``native`` (the C++ host
core) or ``scalar`` (the Python oracle, codec/).  stdin input ('-') is
buffered to memory (the container needs seeking, main.go:117-133); WAV
output buffers all PCM for the 44-byte header (main.go:91-104); PCM mode
streams.  `encode_main` (alac-encode)
takes the encoder's backend words: ``cuda`` and ``cpu`` run the device
encoder there, ``native`` the C++ core, ``python`` the Python encoder.
"""

from __future__ import annotations

import argparse
import io
import sys

from . import __version__
from .decode import new_decoder
from .encoder import encode_wav_to_m4a
from .encoder.encode import BACKENDS as ENCODE_BACKENDS
from .errors import AlacError
from .utils.wav import wav_header

BACKENDS = ("cuda", "cpu", "native", "scalar")


def _open_input(path: str, prog: str):
    """The input as a seekable binary file, or None after reporting why not."""
    if path == "-":
        return io.BytesIO(sys.stdin.buffer.read())
    try:
        return open(path, "rb")
    except OSError as exc:
        print(f"{prog}: {exc}", file=sys.stderr)
        return None


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="alac-decode", description="Decode ALAC (Apple Lossless) M4A/CAF to WAV or raw PCM."
    )
    parser.add_argument("-version", "--version", action="version", version=f"alac-decode {__version__}")
    parser.add_argument("-format", "--format", choices=("wav", "pcm"), default="wav")
    parser.add_argument("-backend", "--backend", choices=BACKENDS, default="cuda",
                        help="where packet windows decode: the card, the CPU, the C++ host core "
                        "or the Python oracle")
    parser.add_argument("-batch", "--batch", type=int, default=64, help="packets per window")
    parser.add_argument("input", help="input .m4a/.caf file, or '-' for stdin")
    parser.add_argument("output", nargs="?", help="output file (default: stdout)")
    args = parser.parse_args(argv)

    reader = _open_input(args.input, "alac-decode")
    if reader is None:
        return 1
    with reader:
        try:
            dec = new_decoder(reader, backend=args.backend, batch_size=args.batch)
        except AlacError as exc:
            print(f"alac-decode: {exc}", file=sys.stderr)
            return 1
        fmt = dec.format()
        print(f"{fmt.sample_rate} Hz, {fmt.bit_depth}-bit, {fmt.channels} ch, "
              f"{dec.duration():.3f}s", file=sys.stderr)
        out = open(args.output, "wb") if args.output else sys.stdout.buffer
        try:
            if args.format == "wav":
                pcm = dec.read()
                out.write(wav_header(fmt, len(pcm)))
                out.write(pcm)
            else:
                while chunk := dec.read(1 << 20):
                    out.write(chunk)
        except AlacError as exc:
            print(f"alac-decode: {exc}", file=sys.stderr)
            return 1
        finally:
            if args.output:
                out.close()
    return 0


def encode_main(argv: list[str] | None = None) -> int:
    """alac-encode: WAV -> ALAC M4A or CAF."""
    parser = argparse.ArgumentParser(
        prog="alac-encode", description="Encode a PCM WAV file to ALAC (Apple Lossless) M4A."
    )
    parser.add_argument("-version", "--version", action="version", version=f"alac-encode {__version__}")
    parser.add_argument("-frame", "--frame", type=int, default=4096, help="samples per packet")
    parser.add_argument("-container", "--container", choices=("m4a", "caf"), default="m4a")
    parser.add_argument("-backend", "--backend", choices=ENCODE_BACKENDS, default="cuda",
                        help="where packets encode: the card, the CPU, the C++ host core or the "
                        "Python encoder")
    parser.add_argument("input", help="input .wav file, or '-' for stdin")
    parser.add_argument("output", nargs="?", help="output .m4a (default: stdout)")
    args = parser.parse_args(argv)

    reader = _open_input(args.input, "alac-encode")
    if reader is None:
        return 1
    with reader:
        try:
            blob = encode_wav_to_m4a(reader, frame_length=args.frame, container=args.container,
                                     backend=args.backend)
        except (ValueError, AlacError) as exc:
            print(f"alac-encode: {exc}", file=sys.stderr)
            return 1
    if args.output:
        with open(args.output, "wb") as out:
            out.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
