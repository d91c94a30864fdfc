"""The port's corpus service against the JAX package's (`backend="native"`)
and the source PCM, byte for byte, on the CPU: cross-file batching grouped
by config over M4A and CAF files, results in input order, completion-order
streaming with a small window, one file spanning many batches, paths and
file objects, an empty file and an empty corpus."""

import io
import threading

import pytest
import torch

from torch_files import alac_file

from saprobe_alac_tpu.service import decode_corpus as jax_decode_corpus
import saprobe_alac_tpu_torch as port
from saprobe_alac_tpu_torch import service


def _mixed():
    return [
        alac_file(16, 2, 128, 500, seed=1),
        alac_file(16, 2, 128, 300, seed=2, container="caf"),  # the first one's group
        alac_file(24, 1, 128, 400, seed=3, bytes_shifted=1),  # a group of its own
        alac_file(16, 2, 128, 129, seed=4),  # the first one's group, 2 packets
        alac_file(24, 1, 128, 150, seed=5, container="caf", bytes_shifted=1),
    ]


def _check(results, files):
    want = jax_decode_corpus([f.reader() for f in files], backend="native")
    assert [r.index for r in results] == list(range(len(files)))
    for res, ref, f in zip(results, want, files):
        assert res.pcm == ref.pcm == f.source
        assert vars(res.format) == vars(ref.format)
        assert (res.samples() == f.pcm).all()


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_mixed_configs_and_containers(backend):
    files = _mixed()
    _check(port.decode_corpus([f.reader() for f in files], backend=backend, batch_size=4), files)


@pytest.mark.parametrize("inflight", [1, 3])
def test_iter_streams_each_file_once(inflight):
    """Completion order, each file once, with a window of 3 packets."""
    files = [alac_file(16, 2, 128, 200 + 17 * i, seed=20 + i) for i in range(5)]
    seen = {}
    for res in service.iter_decode_corpus([f.reader() for f in files], backend="cpu",
                                          batch_size=3, inflight=inflight):
        assert res.index not in seen
        seen[res.index] = res
    _check([seen[i] for i in range(len(files))], files)


def test_file_spanning_many_batches():
    files = [alac_file(16, 1, 64, 64 * 30 + 5, seed=31)]
    (res,) = port.decode_corpus([f.reader() for f in files], backend="cpu", batch_size=8)
    _check([res], files)


def test_paths_and_an_empty_file(tmp_path):
    """Sources given as paths; a file of no packets gives empty PCM in its
    place."""
    files = [alac_file(16, 2, 128, 300, seed=40), alac_file(16, 2, 128, 0, seed=41),
             alac_file(16, 2, 128, 260, seed=42, container="caf")]
    paths = []
    for i, f in enumerate(files):
        paths.append(tmp_path / f"f{i}")
        paths[-1].write_bytes(f.blob)
    results = port.decode_corpus(paths, backend="cpu", batch_size=4)
    assert [r.source for r in results] == [str(p) for p in paths]
    assert results[1].pcm == b""
    _check(results, files)


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_empty_corpus(backend):
    assert port.decode_corpus([], backend=backend) == []
    assert list(service.iter_decode_corpus([], backend=backend)) == []


def test_cuda_service_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default backend decodes on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.decode_corpus([alac_file(16, 2, 128, 300, seed=50).reader()])


def test_scalar_backend_raises():
    """``backend="scalar"`` decodes a clean file to the source and raises
    the JAX scalar service's class on a file with a packet that opens with
    a CCE element (tag 2)."""
    f = alac_file(16, 2, 128, 300, seed=51)
    (res,) = port.decode_corpus([f.reader()], backend="scalar")
    assert res.pcm == f.source
    bad = bytearray(f.blob)
    first = bad.index(f.packets[1])
    bad[first : first + len(f.packets[1])] = b"\x40" * len(f.packets[1])
    with pytest.raises(port.DecodeError) as mine:
        port.decode_corpus([io.BytesIO(bytes(bad))], backend="scalar")
    with pytest.raises(Exception) as ref:
        jax_decode_corpus([io.BytesIO(bytes(bad))], backend="scalar")
    assert type(mine.value).__name__ == type(ref.value).__name__


def test_corpus_iter_threads():
    """Concurrent iter_decode_corpus runs, each with its own window state,
    stay byte-exact and end (tests/test_stress_concurrent.py's corpus case),
    on the C++ core (the plain versions on several threads at once
    oversubscribe the CPU)."""
    sets = [[alac_file(16, 2, 128, 128 * (3 + k) + 13 * t, seed=60 + 10 * t + k)
             for k in range(3)] for t in range(3)]
    results, errors = {}, []

    def worker(t):
        try:
            got = {r.index: r.pcm for r in service.iter_decode_corpus(
                [f.reader() for f in sets[t]], backend="native", batch_size=3, inflight=2)}
            results[t] = got
        except BaseException as exc:  # noqa: BLE001 — reported to pytest
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(t,), daemon=True) for t in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120.0)
        assert not th.is_alive(), "worker thread hung"
    if errors:
        raise errors[0]
    for t, files in enumerate(sets):
        assert results[t] == {i: f.source for i, f in enumerate(files)}
