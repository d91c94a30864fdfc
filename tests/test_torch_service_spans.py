"""The corpus service's own spans and counters (service.py), on the CPU.

Under `torch.profiler.profile(activities=[CPU])` a corpus records one
``alac.service.demux`` and one ``alac.service.join`` a file and one
``alac.service.flush`` at the tail, none of them around a batch call's
spans (so every ``alac.batch.submit`` stays at the top, where the
benchmark counts calls); `program.counts` gains ``files``,
``service_batches``, ``partial_batches`` and ``groups``.  The corpus: two
config groups over a batch of 4, one group with two full batches and a
partial tail, an empty file among them.
"""

import pytest
from torch.profiler import ProfilerActivity, profile

from torch_files import alac_file

from saprobe_alac_tpu.service import iter_decode_corpus as jax_iter_decode_corpus
from saprobe_alac_tpu_torch import service
from saprobe_alac_tpu_torch.ops import program
from saprobe_alac_tpu_torch.utils import profiling

F, BATCH, INFLIGHT = 64, 4, 2
SERVICE = {profiling.DEMUX, profiling.JOIN, profiling.FLUSH}


def _files():
    """Group A (16-bit stereo): 5 + 4 + 0 packets, two full batches and a
    partial one of 1; group B (24-bit mono): 3 packets, a partial batch."""
    return [
        alac_file(16, 2, F, 4 * F + 10, seed=71),
        alac_file(24, 1, F, 2 * F + 7, seed=72, bytes_shifted=1),
        alac_file(16, 2, F, 4 * F, seed=73, container="caf"),
        alac_file(16, 2, F, 0, seed=74),
    ]


@pytest.fixture(scope="module")
def corpus():
    """The files, what the service yielded (in order), the spans recorded
    and the counters of the CPU device."""
    files = _files()
    program.clear()
    program.reset_counts()
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        got = list(service.iter_decode_corpus([f.reader() for f in files], backend="cpu",
                                              batch_size=BATCH, inflight=INFLIGHT))
    recorded = profiling.spans()
    counts = program.counts("cpu")
    profiling.clear_spans()
    return files, got, recorded, counts


def _named(recorded, name):
    return [s for s in recorded if s.name == name]


def test_one_demux_and_one_join_a_file(corpus):
    files, got, recorded, _ = corpus
    demux, join = _named(recorded, profiling.DEMUX), _named(recorded, profiling.JOIN)
    assert [(s.attrs["packets"], s.attrs["bytes"]) for s in demux] == [
        (len(f.packets), sum(map(len, f.packets))) for f in files]
    assert [s.attrs["bytes"] for s in join] == [len(r.pcm) for r in got]
    assert sorted(len(r.pcm) for r in got) == sorted(len(f.source) for f in files)


def test_batch_calls_stay_at_the_top(corpus):
    """No service span holds another span, and every submit is top-level."""
    _, _, recorded, _ = corpus
    submits = _named(recorded, profiling.SUBMIT)
    assert len(submits) == 4 and all(s.parent is None for s in submits)
    ids = {s.id for s in recorded if s.name in SERVICE}
    assert all(s.parent is None for s in recorded if s.name in SERVICE)
    assert not any(s.parent in ids for s in recorded)


def test_flush_only_at_the_tail(corpus):
    """One flush, after the last demux and before the partial batches'
    submits; its ``batches`` are the two partial batches."""
    _, _, recorded, _ = corpus
    (flush,) = _named(recorded, profiling.FLUSH)
    assert flush.attrs["batches"] == 2
    assert max(s.end_ns for s in _named(recorded, profiling.DEMUX)) <= flush.start_ns
    after = [s for s in _named(recorded, profiling.SUBMIT) if s.start_ns >= flush.end_ns]
    assert sorted(s.attrs["packets"] for s in after) == [1, 3]


def test_counters(corpus):
    """Four files, four service batches (two under the batch size, which
    are also the batch layer's calls), two groups."""
    _, _, _, counts = corpus
    assert (counts["files"], counts["service_batches"], counts["partial_batches"],
            counts["groups"]) == (4, 4, 2, 2)
    assert counts["calls"] == counts["service_batches"]
    assert counts["packets"] == 12


def test_yields_unchanged(corpus):
    """The files and their completion order equal the JAX package's service
    (the C++ core) under the same batch and window, and the sources."""
    files, got, _, _ = corpus
    want = list(jax_iter_decode_corpus([f.reader() for f in files], backend="native",
                                       batch_size=BATCH, inflight=INFLIGHT))
    assert [r.index for r in got] == [r.index for r in want]
    assert [r.pcm for r in got] == [r.pcm for r in want]
    assert [r.pcm for r in sorted(got, key=lambda r: r.index)] == [f.source for f in files]
    assert all(vars(a.format) == vars(b.format) for a, b in zip(got, want))


def test_nothing_recorded_without_a_profiler():
    """Without a profiler session nothing is recorded; the counters still
    count."""
    files = _files()
    program.reset_counts()
    profiling.clear_spans()
    got = list(service.iter_decode_corpus([f.reader() for f in files], backend="native",
                                          batch_size=BATCH, inflight=INFLIGHT))
    assert profiling.spans() == []
    counts = program.counts("cpu")
    assert (counts["files"], counts["service_batches"], counts["partial_batches"],
            counts["groups"]) == (len(got), 4, 2, 2)
