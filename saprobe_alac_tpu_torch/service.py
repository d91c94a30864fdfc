"""Corpus decode service: many files, batched across the card, bounded RAM.

Counterpart of saprobe_alac_tpu/service.py.  The single-file facade batches
packets within one stream; this service goes one level up, for mass
transcode and dataset ingest: it demuxes files one at a time, groups their
packets by PacketConfig (one decoder per config), decodes each group in
cross-file batches and reassembles each file's PCM.  Packets from different
files share batches freely because every packet is self-contained (SURVEY
§2.3).

The pipeline is windowed: at any moment it holds one file's compressed
packets being queued, at most ``batch_size`` pending packets per config
group, ``inflight`` dispatched batches, and the decoded PCM of files whose
packets are still in flight.  RAM is O(batch window + largest single file),
whatever the corpus size, and the staging of the next batch overlaps the
card's work on the previous ones through ``BatchDecoder.decode_async``.
A file's packets are read from its container in runs: one read a stretch of
at most `READ_RUN_BYTES` that holds packets in table order, into one buffer
of that size made once a call and reused for every file, then each packet
copied out of it as its own ``bytes``.  That buffer is the call's only
addition to the bound above; no file-sized copy of the container is made.
``backend`` is the `BatchDecoder` device: ``"cuda"`` (default), ``"cpu"``,
``"native"`` or ``"scalar"``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import BinaryIO, Iterator, Sequence

import numpy as np

from .config import PacketConfig
from .decode import demux_stream
from .decoder import HOST_BACKENDS, BatchDecoder
from .formats import PCMFormat
from .ops import program
from .utils.pcmconv import pcm_bytes_to_array
from .utils.profiling import DEMUX, FLUSH, JOIN, span

#: The most bytes one read of a file's packets spans: packets that follow
#: each other in the container are read together while their run fits.
READ_RUN_BYTES = 8 << 20


@dataclass
class DecodedFile:
    """One corpus entry's decode result."""

    source: str
    format: PCMFormat
    pcm: bytes  # interleaved LE signed PCM
    index: int = 0  # position in the input sequence

    def samples(self) -> np.ndarray:
        return pcm_bytes_to_array(self.format, self.pcm)


def _open_stream(src) -> tuple[str, BinaryIO]:
    if hasattr(src, "read"):
        return getattr(src, "name", "<stream>"), src
    return str(src), open(src, "rb")


@dataclass
class _FileState:
    index: int
    name: str
    format: PCMFormat
    remaining: int  # packets not yet decoded
    chunks: list = field(default_factory=list)  # per-packet PCM, file order


@dataclass
class _Group:
    """Per-PacketConfig batching state."""

    decoder: BatchDecoder
    pending: deque = field(default_factory=deque)  # (_FileState, packet bytes)
    inflight: deque = field(default_factory=deque)  # (handle, packets, states)


def iter_decode_corpus(
    sources: Sequence,
    backend="cuda",
    batch_size: int = 256,
    inflight: int = 2,
) -> Iterator[DecodedFile]:
    """Stream-decode a corpus of M4A/CAF files with cross-file batching.

    ``sources``: paths or binary file objects.  Files whose cookies match
    share a decoder and its batches.  Yields each ``DecodedFile`` as soon
    as its last packet lands (completion order; ``DecodedFile.index`` gives
    the input position).  RAM stays bounded by the batching window — see the
    module docstring — so corpora far larger than host memory stream through.

    Under a torch.profiler session it records, beside the batch calls' own
    spans and never around them, ``alac.service.demux`` a file (the demux
    and its packet reads; attributes ``packets``, ``bytes``, ``reads``),
    ``alac.service.join`` a completed file (attribute ``bytes``) and one
    ``alac.service.flush`` at the tail (taking the partial batches;
    attribute ``batches``).  It counts ``files``, ``service_batches``,
    ``partial_batches``, ``groups`` and ``service_reads`` (the container's
    read calls) in `program.counts` (the host
    backends' under ``"cpu"``), whether or not a profiler records.
    """
    groups: dict[PacketConfig, _Group] = {}
    counted = "cpu" if backend in HOST_BACKENDS else backend
    run_buf = bytearray(READ_RUN_BYTES)

    def finish_oldest(g: _Group):
        handle, pkts, states = g.inflight.popleft()
        decoded = g.decoder.finish_async(handle, pkts)
        done = []
        for fs, pcm in zip(states, decoded):
            fs.chunks.append(pcm)
            fs.remaining -= 1
            if fs.remaining == 0:
                done.append(fs)
        return done

    def take(g: _Group, count: int) -> tuple[list, list]:
        """The next ``count`` pending packets, and their files' states."""
        items = [g.pending.popleft() for _ in range(count)]
        return [p for _, p in items], [fs for fs, _ in items]

    def dispatch(g: _Group, pkts: list, states: list):
        """Dispatch a batch; returns any files completed while draining the
        in-flight window."""
        g.inflight.append((g.decoder.decode_async(pkts), pkts, states))
        program.add_counts(counted, service_batches=1,
                           partial_batches=int(len(pkts) < batch_size))
        done = []
        while len(g.inflight) > inflight:
            done.extend(finish_oldest(g))
        return done

    def joined(fs: _FileState) -> DecodedFile:
        with span(JOIN) as s:
            pcm = b"".join(fs.chunks)
            if s.recording:
                s.set(bytes=len(pcm))
        program.add_counts(counted, files=1)
        return DecodedFile(fs.name, fs.format, pcm, fs.index)

    for index, src in enumerate(sources):
        name, reader = _open_stream(src)
        try:
            # The whole file's packets are read before any is queued, so no
            # batch call runs inside the span.
            with span(DEMUX) as s:
                config, samples = demux_stream(reader)
                packets, reads = _read_packets(reader, name, samples, run_buf)
                if s.recording:
                    s.set(packets=len(packets), bytes=sum(map(len, packets)), reads=reads)
        finally:
            if not hasattr(src, "read"):
                reader.close()
        fmt = PCMFormat(
            sample_rate=config.sample_rate,
            bit_depth=config.bit_depth,
            channels=config.num_channels,
        )
        fs = _FileState(index, name, fmt, remaining=len(packets))
        if config not in groups:
            groups[config] = _Group(BatchDecoder(config, backend))
            program.add_counts(counted, groups=1)
        g = groups[config]
        program.add_counts(counted, service_reads=reads)
        if not packets:
            yield joined(fs)
            continue
        for data in packets:
            g.pending.append((fs, data))
            if len(g.pending) >= batch_size:
                for d in dispatch(g, *take(g, batch_size)):
                    yield joined(d)
        del packets  # not held while the next file is read

    # Tail flush: dispatch remaining partial batches, drain every window.
    with span(FLUSH) as s:
        tail = []
        for g in groups.values():
            batches = []
            while g.pending:
                batches.append(take(g, min(batch_size, len(g.pending))))
            tail.append((g, batches))
        if s.recording:
            s.set(batches=sum(len(b) for _, b in tail))
    for g, batches in tail:
        done = []
        for pkts, states in batches:
            done.extend(dispatch(g, pkts, states))
        while g.inflight:
            done.extend(finish_oldest(g))
        for d in done:
            yield joined(d)


def _read_packets(reader: BinaryIO, name: str, samples,
                  buf: bytearray) -> tuple[list[bytes], int]:
    """Each packet of the sample table, read from the container, and the
    read calls made.  Packets are read in runs, in table order: a run grows
    while the next packet starts at or after its end and the run, from its
    first byte to that packet's end, fits in ``buf`` (another track's bytes
    between them are read and skipped).  A run is one seek and one
    ``readinto`` of ``buf``, each packet then copied out as its own
    ``bytes``; a packet larger than ``buf``, or a reader without
    ``readinto``, is read with ``read``."""
    packets, reads, n = [], 0, len(samples)
    view = memoryview(buf)
    readinto = getattr(reader, "readinto", None)
    i = 0
    while i < n:
        lo = samples[i].offset
        hi = lo + samples[i].size
        j = i + 1
        while j < n:
            at, end = samples[j].offset, samples[j].offset + samples[j].size
            if at < hi or end - lo > len(buf):
                break
            hi, j = end, j + 1
        reader.seek(lo)
        if readinto is None or hi - lo > len(buf):
            src = memoryview(reader.read(hi - lo))
            got = len(src)
            reads += 1
        else:
            src, got = view, 0
            while got < hi - lo:
                k = readinto(view[got : hi - lo])
                reads += 1
                if not k:
                    break
                got += k
        for info in samples[i:j]:
            at = info.offset - lo
            if at + info.size > got:
                raise EOFError(f"{name}: short packet read")
            packets.append(bytes(src[at : at + info.size]))
        i = j
    return packets, reads


def decode_corpus(
    sources: Sequence,
    backend="cuda",
    batch_size: int = 256,
) -> list[DecodedFile]:
    """Decode a corpus of M4A/CAF files with cross-file batching.

    Returns results in input order.  This materializes every file's PCM at
    once; for corpora larger than host memory use :func:`iter_decode_corpus`,
    which this wraps.
    """
    results = sorted(
        iter_decode_corpus(sources, backend=backend, batch_size=batch_size),
        key=lambda d: d.index,
    )
    return results
