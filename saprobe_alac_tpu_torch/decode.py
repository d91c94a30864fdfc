"""Streaming M4A/CAF decoder facade.

Counterpart of saprobe_alac_tpu/decode.py (reference decode.go:32-190): a
file-like reader over decoded PCM with O(1) packet-aligned seek,
duration/position arithmetic and on-demand decode.  On the card the facade
decodes a window of packets as one batch, and dispatches the next window
before it waits for the current one (`_fill_buffer`).

``backend``: ``"cuda"`` (default; raises without a card) and ``"cpu"`` (the
kernels' plain versions) decode windows through `BatchDecoder`, also
one-packet windows when ``batch_size == 1``; ``"native"`` (the C++ core)
and ``"scalar"`` (the Python oracle) decode windows on the host, and single
packets by `PacketDecoder` when ``batch_size == 1``.

Under a torch.profiler session a decoder records (utils/profiling.py)
``alac.decoder.open`` around the constructor's demux (attribute
``packets``), ``alac.decoder.seek`` a seek (attributes ``exact``, 0 or 1,
and ``dropped``, 1 where it let a dispatched window go; `seek_exact`'s
skip read inside it), ``alac.decoder.read`` a read (attributes ``bytes``
and ``windows``, the windows it dispatched), ``alac.decoder.packets``
around the reads of a window's packets from the container (attributes
``packets`` and ``bytes``; inside a read or a seek, beside the batch calls
and never around them), and ``alac.decoder.close`` where a decoder is let
go with a dispatched window (attribute ``dropped``).  It counts
``decoder_opens``, ``decoder_windows`` and ``prefetch_dropped`` in
`program.counts` (the host backends' under ``"cpu"``), whether or not a
profiler records.
"""

from __future__ import annotations

import contextlib
import math
from typing import BinaryIO

from .caf import find_alac_track_caf, sniff_container
from .config import parse_magic_cookie
from .decoder import HOST_BACKENDS, BatchDecoder, PacketDecoder
from .formats import PCMFormat, bytes_per_sample
from .mp4 import SampleInfo, find_alac_track
from .ops import program
from .utils.pcmconv import pcm_bytes_to_array
from .utils.profiling import CLOSE, OPEN, PACKETS, READ, SEEK, span


def demux_stream(reader: BinaryIO):
    """Sniff the container (MP4/M4A or CAF) and demux the ALAC track:
    (PacketConfig, flat sample table)."""
    if sniff_container(reader) == "caf":
        cookie, samples = find_alac_track_caf(reader)
    else:
        cookie, samples = find_alac_track(reader)
    return parse_magic_cookie(cookie), samples


def sample_at(t: float, rate: int) -> int:
    """The sample at time ``t`` of a stream of ``rate`` samples a second:
    floor(t * rate), where a product within float rounding of a whole
    number is that number.  So ``t = s / rate`` gives ``s`` back, which
    ``int(t * rate)`` does not for 8% of the samples of a 44.1 kHz stream
    (the product falls one ulp short)."""
    x = t * rate
    n = round(x)
    return n if abs(x - n) <= 1e-12 * abs(x) else math.floor(x)


class Decoder:
    """Streams decoded PCM from an ALAC M4A/MP4 or CAF source.

    The container (sample table, config) is parsed up front; PCM is decoded
    in packet windows on demand by :meth:`read`."""

    def __init__(self, reader: BinaryIO, backend="cuda", batch_size: int = 64):
        self._counted = "cpu" if backend in HOST_BACKENDS else backend
        with span(OPEN) as s:
            config, samples = demux_stream(reader)
            if s.recording:
                s.set(packets=len(samples))
        self._reader = reader
        self.config = config
        self._samples: list[SampleInfo] = samples
        self._sample_idx = 0
        self._buf = b""
        self._buf_off = 0
        self._eof = False
        self._batch_size = max(1, batch_size)
        if backend in HOST_BACKENDS and self._batch_size == 1:
            self._packet_dec, self._batch_dec = PacketDecoder(config, backend), None
        else:
            self._packet_dec, self._batch_dec = None, BatchDecoder(config, backend)
        # The dispatched next window: (first sample index, packets, handle).
        self._prefetch = None
        #: Windows dispatched so far.
        self._windows = 0
        program.add_counts(self._counted, decoder_opens=1)

    def __del__(self):
        # A decoder let go with the window ahead dispatched throws that work
        # away (a constructor that raised leaves no `_prefetch`).
        if getattr(self, "_prefetch", None) is not None:
            with span(CLOSE, dropped=1):
                self._drop_prefetch()

    # --- Format / timing (decode.go:78-97) ---

    def format(self) -> PCMFormat:
        return PCMFormat(self.config.sample_rate, self.config.bit_depth, self.config.num_channels)

    def duration(self) -> float:
        """Total stream duration in seconds (packet-count approximation)."""
        return len(self._samples) * self.config.frame_length / self.config.sample_rate

    def position(self) -> float:
        """Current playback position in seconds."""
        return self._sample_idx * self.config.frame_length / self.config.sample_rate

    # --- Seek (decode.go:103-124) ---

    def seek(self, t: float) -> float:
        """Seek to time ``t`` seconds; returns the actual (packet-aligned)
        position.  Negative seeks clamp to the start, past-end to the end."""
        with span(SEEK, exact=0) as s:
            return self._seek(t, s)

    def _seek(self, t: float, s) -> float:
        """`seek` inside the span ``s`` of a seek or a `seek_exact`."""
        target = sample_at(t, self.config.sample_rate) // self.config.frame_length
        target = max(0, min(target, len(self._samples)))
        self._sample_idx = target
        self._buf = b""
        self._buf_off = 0
        self._eof = target >= len(self._samples)
        dropped = self._drop_prefetch()  # the dispatched window no longer follows
        if s.recording:
            s.set(dropped=dropped)
        return target * self.config.frame_length / self.config.sample_rate

    def seek_exact(self, t: float) -> float:
        """Sample-accurate seek: positions on the sample for time ``t`` by
        decoding and dropping the packet's prefix."""
        with span(SEEK, exact=1) as s:
            target_sample = max(0, sample_at(t, self.config.sample_rate))
            pos = self._seek(t, s)
            aligned_sample = round(pos * self.config.sample_rate)
            skip = target_sample - aligned_sample
            if skip > 0 and not self._eof:
                bpf = self.config.num_channels * bytes_per_sample(self.config.bit_depth)
                skipped = len(self.read(skip * bpf)) // bpf
                return (aligned_sample + skipped) / self.config.sample_rate
            return pos

    def _drop_prefetch(self) -> int:
        """Let the dispatched window go, unread: 1 (counted as
        ``prefetch_dropped``) if there was one, else 0."""
        if self._prefetch is None:
            return 0
        self._prefetch = None
        program.add_counts(self._counted, prefetch_dropped=1)
        return 1

    # --- Read (decode.go:127-190) ---

    def read(self, n: int = -1) -> bytes:
        """Read up to ``n`` decoded PCM bytes (all that remain if n < 0);
        b"" at the end of the stream."""
        with span(READ) as s:
            windows = self._windows
            out = self._read(n)
            if s.recording:
                s.set(bytes=len(out), windows=self._windows - windows)
            return out

    def _read(self, n: int | None) -> bytes:
        if n is None or n < 0:
            chunks = []
            while chunk := self._read(1 << 20):
                chunks.append(chunk)
            return b"".join(chunks)
        out = bytearray()
        while len(out) < n:
            if self._buf_off < len(self._buf):
                take = min(n - len(out), len(self._buf) - self._buf_off)
                out += self._buf[self._buf_off : self._buf_off + take]
                self._buf_off += take
                continue
            if self._eof or self._sample_idx >= len(self._samples):
                self._eof = True
                break
            self._fill_buffer()
        return bytes(out)

    def _read_packets(self, start: int, count: int) -> list[bytes]:
        """Packets ``start`` .. ``start + count - 1`` of the sample table, in
        one read of the bytes they span: a window's packets lie together in
        the media data (another track's bytes between them are read and
        skipped), and a read a packet costs a system call and a turn of the
        interpreter lock each."""
        with span(PACKETS) as s:
            infos = self._samples[start : start + count]
            lo = min((i.offset for i in infos), default=0)
            hi = max((i.offset + i.size for i in infos), default=0)
            self._reader.seek(lo)
            blob = self._reader.read(hi - lo)
            packets = []
            for k, info in enumerate(infos):
                at = info.offset - lo
                if at + info.size > len(blob):
                    raise EOFError(f"short read for packet {start + k}: "
                                   f"{max(0, len(blob) - at)} < {info.size}")
                packets.append(blob[at : at + info.size])
            if s.recording:
                s.set(packets=len(packets), bytes=sum(map(len, packets)))
            return packets

    def _dispatch(self, packets: list[bytes]):
        """Dispatch a window through `BatchDecoder` (counted)."""
        self._windows += 1
        program.add_counts(self._counted, decoder_windows=1)
        return self._batch_dec.decode_async(packets)

    def _fill_buffer(self) -> None:
        """Decode the next window into the drain buffer.  Through
        `BatchDecoder` the window after it is dispatched before this one is
        waited for, so its staging and kernels overlap this one's download
        and trim; a seek drops it."""
        if self._batch_dec is None:
            (packet,) = self._read_packets(self._sample_idx, 1)
            self._windows += 1
            program.add_counts(self._counted, decoder_windows=1)
            self._buf = self._packet_dec.decode_packet(packet)
            self._buf_off = 0
            self._sample_idx += 1
            return
        if self._prefetch is not None and self._prefetch[0] == self._sample_idx:
            _, packets, handle = self._prefetch
        else:
            packets = self._read_packets(self._sample_idx, self._batch_size)
            handle = self._dispatch(packets)
        self._prefetch = None
        nxt = self._sample_idx + len(packets)
        if nxt < len(self._samples):
            nxt_packets = self._read_packets(nxt, self._batch_size)
            self._prefetch = (nxt, nxt_packets, self._dispatch(nxt_packets))
        self._buf = b"".join(self._batch_dec.finish_async(handle, packets))
        self._buf_off = 0
        self._sample_idx = nxt


def new_decoder(reader: BinaryIO, backend="cuda", batch_size: int = 64) -> Decoder:
    """Open an M4A/MP4 or CAF stream of ALAC audio (reference NewDecoder)."""
    return Decoder(reader, backend=backend, batch_size=batch_size)


def decode_file(path_or_reader, backend="cuda"):
    """Decode a whole M4A/CAF, from a path or a binary file object, to
    (PCMFormat, (n, channels) int64 samples)."""
    if hasattr(path_or_reader, "read"):
        cm = contextlib.nullcontext(path_or_reader)
    else:
        cm = open(path_or_reader, "rb")
    with cm as f:
        dec = Decoder(f, backend=backend)
        fmt = dec.format()
        return fmt, pcm_bytes_to_array(fmt, dec.read())
