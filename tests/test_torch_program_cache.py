"""The process-wide program cache (ops/program.py) on the CPU, where every
cached program runs its core eagerly: at its first use on the caller's
data, keeping nothing, from its second on static inputs of its own.

Decoders of one (device, decode statics) share one program a key, across
decoders, threads and files, as the JAX package's jitted executables are
shared by every caller in the process; configs that differ only in fields
the device code does not read (sample rate, max_run, max_frame_bytes,
avg_bit_rate) share, those that differ in C or kb do not.  The cache keeps
what its programs hold (static inputs, and pools, set by hand here: a CPU
program captures nothing) within its budget, the least recently used
released first and the most recent kept, and keys used once within
`MAX_KEYS`, and a program released while another thread holds it
never runs.  `encode_walk` and the framed audio features run as programs too,
equal to their direct calls and to the JAX package's functions.  Decoded
bytes are held against the source PCM (the encoders are lossless, as
tests/test_torch_batch.py holds against the JAX decoder and the oracle)."""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import expected_pcm_bytes, make_config, music_pcm
from test_torch_program import pool_at_first_use
from torch_files import alac_file

from saprobe_alac_tpu.ops import audio as jax_audio
from saprobe_alac_tpu.ops import encode_device as ed
import saprobe_alac_tpu_torch as port
from saprobe_alac_tpu_torch import PacketConfig, TorchBatchDecoder
from saprobe_alac_tpu_torch.ops import audio, program
from saprobe_alac_tpu_torch.ops import encode_device as ted

F = 128
N = 8


@pytest.fixture(autouse=True)
def fresh_cache():
    """Each test starts and ends with an empty cache and zero counts."""
    program.clear()
    program.reset_counts()
    yield
    program.clear()


def _case(channels=2, kb=14, n=N * F - 21, seed=11, **fields):
    """(port config, packets, source bytes) of ``n`` samples of music."""
    cfg = PacketConfig(**dataclasses.asdict(
        make_config(depth=16, channels=channels, frame_length=F, kb=kb)))
    cfg = dataclasses.replace(cfg, **fields)
    pcm = music_pcm(n, channels, 16, seed=seed)
    packets = port.encode_packets(cfg, port.EncoderSpec(), pcm, backend="native")
    return cfg, packets, expected_pcm_bytes(pcm, 16)


def _decode(dec, packets, rows=None):
    return b"".join(dec.finish_async(dec.decode_async(packets, rows=rows), packets))


def test_two_decoders_of_one_config_share_one_program():
    cfg, pk, src = _case()
    one, two = TorchBatchDecoder(cfg, "cpu"), TorchBatchDecoder(cfg, "cpu")
    assert _decode(one, pk) == _decode(two, pk) == src
    (prog,) = program.programs("cpu")
    assert prog.uses == 2 and prog.kind == "decode"
    assert prog.statics == (F, 2, 16, 40, 10, 14) == one.statics
    assert program.counts("cpu")["programs"] == 1


@pytest.mark.parametrize("field,value", [
    ("sample_rate", 96000), ("max_run", 10), ("max_frame_bytes", 4096),
    ("avg_bit_rate", 1411200)])
def test_configs_that_differ_only_in_fields_the_device_ignores_share(field, value):
    """The JAX jit's static arguments are F, C, depth, pb, mb and kb: a
    config that differs in another field runs the same program."""
    cfg, pk, src = _case()
    other = dataclasses.replace(cfg, **{field: value})
    assert other != cfg
    assert _decode(TorchBatchDecoder(cfg, "cpu"), pk) == src
    assert _decode(TorchBatchDecoder(other, "cpu"), pk) == src
    assert [p.uses for p in program.programs("cpu")] == [2]


@pytest.mark.parametrize("field", ["num_channels", "kb"])
def test_configs_that_differ_in_c_or_kb_do_not_share(field):
    cfg, pk, src = _case()
    cfg2, pk2, src2 = _case(**{"num_channels": {"channels": 1}, "kb": {"kb": 10}}[field])
    assert getattr(cfg2, field) != getattr(cfg, field)
    assert _decode(TorchBatchDecoder(cfg, "cpu"), pk) == src
    assert _decode(TorchBatchDecoder(cfg2, "cpu"), pk2) == src2
    progs = program.programs("cpu")
    assert len(progs) == 2 and progs[0].statics != progs[1].statics
    assert [p.uses for p in progs] == [1, 1]


def test_eviction_by_bytes_keeps_the_most_recent(monkeypatch):
    """Pools of 100, 100 and 400 bytes under a budget of 250: the third
    evicts the two older ones and stays though it alone passes the budget;
    the first key again evicts it.  The resident pools never pass the
    budget plus the largest pool."""
    cfg, pk, src = _case()
    sizes = {8: 100, 12: 100, 16: 400}
    pool_at_first_use(monkeypatch, lambda prog: sizes[prog.shape[0]])
    monkeypatch.setattr(program, "BUDGET", 250)
    dec = TorchBatchDecoder(cfg, "cpu")
    steps = []
    for rows in (8, 12, 16, 8):
        assert _decode(dec, pk, rows=rows) == src
        c = program.counts("cpu")
        assert c["resident_bytes"] <= 250 + max(sizes.values())
        steps.append(([p.shape[0] for p in program.programs("cpu")], c["resident_bytes"],
                      c["evictions"]))
    assert steps == [([8], 100, 0), ([8, 12], 200, 0), ([16], 400, 2), ([8], 100, 3)]


class TurnLock:
    """A lock that goes to waiting threads in the order of ``names``: it
    lets a test choose which of two threads blocked on one program's lock
    takes it first."""

    def __init__(self, names):
        self._cv = threading.Condition()
        self._turns = list(names)
        self._held = False
        self.waiting = set()

    def __enter__(self):
        me = threading.current_thread().name
        with self._cv:
            self.waiting.add(me)
            self._cv.notify_all()
            self._cv.wait_for(lambda: not self._held and self._turns[:1] in ([], [me]))
            self._turns = self._turns[1:]
            self._held = True
            self.waiting.discard(me)

    def __exit__(self, *exc):
        with self._cv:
            self._held = False
            self._cv.notify_all()

    def acquire(self):
        self.__enter__()
        return True

    def release(self):
        self.__exit__()

    def wait_until(self, names, timeout=60):
        with self._cv:
            return self._cv.wait_for(lambda: self.waiting >= set(names), timeout)


@pytest.mark.parametrize("first", ["holder", "evictor"])
def test_a_program_evicted_while_a_thread_holds_it(monkeypatch, first):
    """Thread A has taken program P from the cache and waits for its lock;
    thread B's run on another key passes the budget and evicts P, then
    waits for P's lock to release it.  Whichever gets the lock first, no
    released program runs (A runs P before B releases it, or finds it
    released and runs a new program of its key), and both results equal the
    source."""
    cfg, pk, src = _case()
    pool_at_first_use(monkeypatch, lambda prog: 100)
    monkeypatch.setattr(program, "BUDGET", 100)
    ran = []
    real = program.Program.run

    def run(self, sources):
        assert not self.released, "a released program ran"
        ran.append((threading.current_thread().name, self))
        return real(self, sources)

    monkeypatch.setattr(program.Program, "run", run)
    dec = TorchBatchDecoder(cfg, "cpu")
    assert _decode(dec, pk, rows=8) == src
    (p,) = program.programs("cpu")
    order = ["MainThread", "A", "B"] if first == "holder" else ["MainThread", "B", "A"]
    p.lock = TurnLock(order)
    out = {}

    def decode(name, rows):
        out[name] = _decode(dec, pk, rows=rows)

    p.lock.__enter__()
    a = threading.Thread(target=decode, args=("A", 8), name="A")
    b = threading.Thread(target=decode, args=("B", 12), name="B")
    try:
        a.start()
        assert p.lock.wait_until({"A"})
        b.start()
        assert p.lock.wait_until({"A", "B"})  # B evicted P and waits to release it
        assert p not in program.programs("cpu")
    finally:
        p.lock.__exit__(None, None, None)
    for t in (a, b):
        t.join(120)
        assert not t.is_alive()
    assert out == {"A": src, "B": src}
    assert p.released
    a_ran = [prog for name, prog in ran if name == "A"]
    assert a_ran == ([p] if first == "holder" else [a_ran[0]])
    assert (a_ran[0] is p) == (first == "holder")


def test_two_decoders_in_two_threads_on_one_key():
    cfg, pk, src = _case()
    decs = [TorchBatchDecoder(cfg, "cpu") for _ in range(2)]
    barrier = threading.Barrier(2)
    out = [None, None]

    def work(i):
        barrier.wait(30)
        out[i] = [_decode(decs[i], pk) for _ in range(2)]

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert out == [[src, src], [src, src]]
    assert [p.uses for p in program.programs("cpu")] == [4]


def _walk_inputs(B=8, frame=256, seed=3):
    """Seeded inputs of one stereo 16-bit encode_walk at B lanes (two
    partial, one empty), order 4 with pinned coefficients."""
    rng = np.random.default_rng(seed)
    planes = np.zeros((B, 2, frame), np.int32)
    ns = np.full(B, frame, np.int32)
    ns[-3:] = (frame - 77, 5, 0)
    for i in range(B):
        planes[i, :, : ns[i]] = music_pcm(int(ns[i]), 2, 16, seed=int(rng.integers(1 << 20))).T
    coefs = np.zeros((1, 32), np.int32)
    coefs[0, :4] = (160, 80, 40, 20)
    kw = dict(frame_length=frame, num_channels=2, depth=16, pb=40, mb=10, kb=14,
              elem_specs=((4, 9, (4,), 0, False),), mix_bits_s=2, bytes_shifted=0,
              use_lfe_tag=False, force_escape=False, auto_escape=False)
    return (planes, ns, np.full(B, 2, np.int32), coefs), kw


def test_encode_walk_program_reuses_one_program_and_matches_jax():
    """Two calls on one key run one program; its words and bits equal a
    direct `encode_walk` call's and the JAX package's `encode_walk` (the
    XLA lockstep encoder) on the same seeded inputs, B=8, F=256."""
    sources, kw = _walk_inputs()
    first = ted.encode_walk_program(sources, "cpu", **kw)
    words, bits, ovf = ted.encode_walk_program(sources, "cpu", **kw)
    (prog,) = program.programs("cpu")
    assert prog.kind == "encode_walk" and prog.uses == 2 and prog.shape == (8,)
    for a, b in zip(first, (words, bits, ovf)):
        assert torch.equal(a, b)
    direct = ted.encode_walk(*(torch.from_numpy(a) for a in sources), **kw)
    assert torch.equal(words, direct[0]) and torch.equal(bits, direct[1])
    assert not ovf.any()
    jw, jb, jo = ed.encode_walk(*(jnp.asarray(a) for a in sources), *kw.values(),
                                enc_impl="xla")
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jb))
    assert not np.asarray(jo).any()


def _mono(seed, shape=(3, 3000)):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("name", ["pcm_to_float", "frame_energy", "log_spectrogram"])
def test_features_as_programs(name):
    """Two calls of a framed feature on one shape run one program, equal to
    the eager formulas and within tests/test_torch_profiling_audio.py's atol
    1e-4 of the JAX package's functions; `pcm_to_float` (one cast and
    scale) runs directly and makes no program."""
    if name == "pcm_to_float":
        x = np.random.default_rng(5).integers(-(1 << 15), 1 << 15, (2, 64, 2)).astype(np.int32)
        port_fn = lambda t: audio.pcm_to_float(t, 16)  # noqa: E731
        eager = audio._to_float(torch.from_numpy(x), 16)
        want = jax_audio.pcm_to_float(jnp.asarray(x), 16)
    elif name == "frame_energy":
        x = _mono(7)
        port_fn = lambda t: audio.frame_energy(t, 256, 100)  # noqa: E731
        eager = audio._energy(torch.from_numpy(x), audio._frame_index(3000, 256, 100, "cpu"))
        want = jax_audio.frame_energy(jnp.asarray(x), frame=256, hop=100)
    else:
        x = _mono(8)
        port_fn = lambda t: audio.log_spectrogram(t, 256, 128, 129)  # noqa: E731
        eager = audio._log_spec(torch.from_numpy(x), audio._frame_index(3000, 256, 128, "cpu"),
                                audio._hann(256, torch.float32, "cpu"), 129)
        want = jax_audio.log_spectrogram(jnp.asarray(x), frame=256, hop=128, n_bins=129)
    got = [port_fn(torch.from_numpy(x)) for _ in range(2)]
    if name == "pcm_to_float":
        assert program.programs("cpu") == []
    else:
        (prog,) = program.programs("cpu")
        assert prog.kind == name and prog.uses == 2
    assert torch.equal(got[0], eager) and torch.equal(got[1], eager)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_a_second_new_decoder_on_one_file_captures_nothing():
    """A file's second decoder finds every program its windows need: it
    makes no program and captures nothing; it runs the first decoder's
    programs (on the card each of these runs is one replay)."""
    f = alac_file(n=13 * F + 57, seed=21)

    def read():
        return port.new_decoder(f.reader(), backend="cpu", batch_size=8).read()

    assert read() == f.source
    first = {id(p): p.uses for p in program.programs("cpu")}
    program.reset_counts()
    assert read() == f.source
    c = program.counts("cpu")
    assert (c["programs"], c["captures"], c["evictions"]) == (0, 0, 0)
    assert c["eager"] == 2  # windows of 8 and 6 packets: buckets 8 and 8
    again = {id(p): p.uses for p in program.programs("cpu")}
    assert again.keys() == first.keys() and sum(again.values()) == sum(first.values()) + 2


def test_budget_is_the_module_constant_or_none_on_the_cpu(monkeypatch):
    """`BUDGET` when set; unset, the CPU's default is `HOST_BUDGET` (a card's
    is a quarter of its memory)."""
    assert program.BUDGET is None and program.budget("cpu") == program.HOST_BUDGET == 1 << 30
    monkeypatch.setattr(program, "BUDGET", 12345)
    assert program.budget("cpu") == 12345


def test_a_key_used_once_keeps_nothing():
    """A program's first use runs on the caller's data and allocates no
    static input; its second allocates them, and they are what the cache
    counts."""
    x = torch.from_numpy(_mono(3, (2, 1500)))
    first = audio.frame_energy(x, 256, 128)
    (prog,) = program.programs("cpu")
    assert prog.inputs is None and prog.resident_bytes == 0
    assert program.counts("cpu")["resident_bytes"] == 0
    assert torch.equal(audio.frame_energy(x, 256, 128), first)
    assert prog.inputs[0].shape == x.shape and prog.resident_bytes == x.numel() * 4
    assert program.counts("cpu")["resident_bytes"] == x.numel() * 4


@pytest.mark.parametrize("name", ["frame_energy", "log_spectrogram"])
def test_many_feature_shapes_leave_a_bounded_cache(monkeypatch, name):
    """Audio of 24 lengths, each length twice (so each key keeps its static
    input): under a budget of three inputs' bytes the cache evicts, keeps
    the resident bytes within the budget plus the largest program, and every
    result equals the eager formula's."""
    fn = getattr(audio, name)
    largest = 2 * (1000 + 23 * 37) * 4
    monkeypatch.setattr(program, "BUDGET", 3 * largest)
    for k in range(24):
        x = torch.from_numpy(_mono(100 + k, (2, 1000 + 37 * k)))
        want = fn(x, 256, 128)
        assert torch.equal(fn(x, 256, 128), want)
        c = program.counts("cpu")
        assert c["resident_bytes"] <= 3 * largest + largest
        assert c["cached"] <= 5
    assert program.counts("cpu")["evictions"] >= 20


def test_keys_used_once_are_bounded_by_count(monkeypatch):
    """Keys used once keep no bytes, so only `MAX_KEYS` bounds them: 12
    lengths each used once leave the 4 most recent."""
    monkeypatch.setattr(program, "MAX_KEYS", 4)
    for k in range(12):
        audio.frame_energy(torch.from_numpy(_mono(200 + k, (1, 600 + k))), 256, 128)
    progs = program.programs("cpu")
    assert [p.shape[0][1] for p in progs] == [608, 609, 610, 611]
    c = program.counts("cpu")
    assert (c["cached"], c["resident_bytes"], c["evictions"]) == (4, 0, 8)
