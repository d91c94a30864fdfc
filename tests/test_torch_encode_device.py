"""The port's device encoder against the JAX package's, on CPU tensors.

The same PCM, made from a seed with numpy, and the same spec (carried over
with `interop.encoder_spec_from_jax`) go through `encode_packets_device` of
both packages.  With fitting off (pinned coefficients, or order 0/31) the
packets are equal byte for byte, tolerance 0; the JAX package runs its XLA
lockstep encoder (`ed._IMPL = "xla"`) and, for two small cases, its Pallas
kernels in interpret mode.  With fitting on, the float32 Levinson-Durbin
sums run in another order in the two frameworks, so the coefficients may
differ by one step and the packets in size: there each packet of the port
decodes through the scalar oracle to its source, the total size is within 1%
of the JAX package's, and the fitted coefficients are within +-1.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import expected_pcm_bytes, make_config, music_pcm

from saprobe_alac_tpu.codec import decode_packet as oracle
from saprobe_alac_tpu.encoder import EncoderSpec
from saprobe_alac_tpu.encoder.encode import ChannelSpec
from saprobe_alac_tpu.ops import encode_device as ed
import saprobe_alac_tpu_torch as port
from saprobe_alac_tpu_torch import native
from saprobe_alac_tpu_torch.interop import encoder_spec_from_jax
from saprobe_alac_tpu_torch.ops import encode_device as ted

F = 160
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_COEFS = [160, 80, 40, 20, 10, 5, 3, 2] * 4


@pytest.fixture
def jax_impl():
    """Sets the JAX package's encode implementation for one test."""
    old = ed._IMPL

    def choose(impl):
        ed._IMPL = impl

    choose("xla")
    yield choose
    ed._IMPL = old


def spec_for(order, **kw):
    coefs = _COEFS[:order] if order not in (0, 31) else []
    return EncoderSpec(channel=ChannelSpec(order=order, coefs=coefs, fit=False), **kw)


def both(cfg, spec, pcms):
    """(the port's packets, the JAX package's) for one batch."""
    got = port.encode_packets_device(cfg, encoder_spec_from_jax(spec), pcms, device="cpu")
    return got, ed.encode_packets_device(cfg, spec, pcms)


def assert_equal_and_lossless(cfg, spec, pcms):
    got, want = both(cfg, spec, pcms)
    assert got == want
    for pkt, pcm in zip(got, pcms):
        assert oracle(cfg, pkt)[0] == expected_pcm_bytes(pcm, cfg.bit_depth)


@pytest.mark.parametrize(
    "depth,channels,order,bs,mix_res",
    [
        (16, 2, 4, 0, 1),
        (16, 1, 8, 0, 0),
        (24, 2, 4, 1, 1),
        (16, 6, 4, 0, 1),
        (16, 2, 0, 0, 1),
        (16, 2, 31, 0, 1),
        (32, 2, 4, 0, 1),
        (24, 8, 4, 1, 2),
        (16, 2, 12, 0, -3),
    ],
    ids=["std", "mono8", "bs24", "5.1", "o0", "o31", "d32", "7.1bs", "o12mixneg"],
)
def test_byte_identical_to_jax(jax_impl, depth, channels, order, bs, mix_res):
    cfg = make_config(depth=depth, channels=channels, frame_length=F)
    pcm = music_pcm(F, channels, depth, seed=depth + channels + order)
    assert_equal_and_lossless(cfg, spec_for(order, bytes_shifted=bs, mix_res=mix_res), [pcm])


@pytest.mark.parametrize("channels", [3, 4, 5, 7])
def test_byte_identical_other_layouts(jax_impl, channels):
    cfg = make_config(depth=16, channels=channels, frame_length=64)
    pcm = music_pcm(64, channels, 16, seed=channels)
    assert_equal_and_lossless(cfg, spec_for(4), [pcm])


@pytest.mark.parametrize("case", ["std", "o12_mode1"])
def test_byte_identical_to_jax_pallas_interpret(jax_impl, case):
    """Against the JAX package's forward LPC and encode kernels in interpret
    mode, as tests/test_encode_kernel.py runs them."""
    jax_impl("pallas_interpret")
    cfg = make_config(depth=16, channels=2, frame_length=64)
    rng = np.random.default_rng(5)
    pcm = rng.integers(-3000, 3000, (64 * 2, 2)).astype(np.int64)
    if case == "std":
        spec = EncoderSpec(channel=ChannelSpec(order=4, den_shift=9, coefs=[120, -60, 30, -10]))
    else:
        spec = EncoderSpec(channel=ChannelSpec(order=12, coefs=_COEFS[:12], mode=1))
    assert_equal_and_lossless(cfg, spec, [pcm[:64], pcm[64:]])


def test_batch_and_partials(jax_impl):
    cfg = make_config(depth=16, channels=2, frame_length=F)
    pcms = [music_pcm(F, 2, 16, seed=i) for i in range(5)] + [music_pcm(77, 2, 16, seed=9)]
    assert_equal_and_lossless(cfg, spec_for(4, mix_res=1), pcms)


def test_silence_zero_runs(jax_impl):
    cfg = make_config(depth=16, channels=2, frame_length=F)
    pcm = np.zeros((F, 2), dtype=np.int64)
    pcm[50, 0] = 7
    assert_equal_and_lossless(cfg, spec_for(4, mix_res=1), [pcm])


def test_auto_escape_on_noise(jax_impl):
    cfg = make_config(depth=16, channels=2, frame_length=F)
    spec = EncoderSpec(channel=ChannelSpec(order=4, coefs=[160, 80, 40, 20], fit=False))
    noise = music_pcm(F, 2, 16, seed=2, tonality=0.0)
    got, want = both(cfg, spec, [noise])
    assert got == want
    assert got[0][2] & 0x02  # the element header's escape flag


def test_uncodable_gate_at_32_bits(jax_impl):
    """A residual of INT32_MIN at chan_bits 32 forces the verbatim element."""
    cfg = make_config(depth=32, channels=1, frame_length=F)
    pcm = np.full((F, 1), (1 << 31) - 1, dtype=np.int64)
    pcm[0, 0] = 0
    spec = EncoderSpec(channel=ChannelSpec(order=4, coefs=[160, 80, 40, 20], fit=False),
                       auto_escape=False)
    assert_equal_and_lossless(cfg, spec, [pcm])


def test_large_unsigned_quotients(jax_impl):
    """A quotient of 2^31 or more must still escape (unsigned compare)."""
    cfg = make_config(depth=32, channels=1, frame_length=64)
    pcm = np.zeros((64, 1), dtype=np.int64)
    pcm[1::2] = (1 << 30) + 12345
    assert_equal_and_lossless(cfg, spec_for(4), [pcm])


def test_empty_batch():
    cfg = make_config(depth=16, channels=2, frame_length=64)
    assert port.encode_packets_device(cfg, port.EncoderSpec(), [], device="cpu") == []


def test_mix_bits_zero(jax_impl):
    cfg = make_config(depth=16, channels=2, frame_length=64)
    assert_equal_and_lossless(cfg, spec_for(4, mix_bits=0, mix_res=2), [music_pcm(64, 2, 16, seed=1)])


def test_mix_overflow_guard(jax_impl):
    """A mix that leaves chan_bits keeps the channels independent."""
    cfg = make_config(depth=16, channels=2, frame_length=64)
    pcm = np.zeros((64, 2), dtype=np.int64)
    pcm[:, 0], pcm[:, 1] = 32767, -32768
    pcm[::2] = pcm[::2, ::-1]
    assert_equal_and_lossless(cfg, spec_for(4, mix_bits=1, mix_res=127), [pcm])


@pytest.mark.parametrize("order", [4, 31])
def test_mode_delta_prepass(jax_impl, order):
    cfg = make_config(depth=16, channels=2, frame_length=F)
    coefs = [160, 80, 40, 20] if order == 4 else []
    spec = EncoderSpec(channel=ChannelSpec(order=order, coefs=coefs, fit=False, mode=1))
    assert_equal_and_lossless(cfg, spec, [music_pcm(F, 2, 16, seed=3, tonality=0.8)])


def test_adaptive_pb_candidates(jax_impl):
    cfg = make_config(depth=16, channels=2, frame_length=F)
    spec = EncoderSpec(channel=ChannelSpec(
        order=4, coefs=[160, 80, 40, 20], fit=False, pb_candidates=(2, 4, 7)))
    pcms = [music_pcm(F, 2, 16, seed=s, tonality=t) for s, t in [(1, 0.9), (2, 0.2), (3, 0.6)]]
    assert_equal_and_lossless(cfg, spec, pcms)


def test_per_element_specs(jax_impl):
    """5.1: SCE + CPE + CPE + LFE, mixed orders and modes on one packet."""
    cfg = make_config(depth=16, channels=6, frame_length=F)

    def mk(o, m=0):
        return ChannelSpec(order=o, coefs=[160, 80, 40, 20, 10, 5][:o], fit=False, mode=m)

    spec = EncoderSpec(channel=mk(4), elements=[mk(2), mk(6), mk(4, m=1), mk(0)], mix_res=1)
    assert_equal_and_lossless(cfg, spec, [music_pcm(F, 6, 16, seed=11)])
    with pytest.raises(ValueError):
        bad = encoder_spec_from_jax(EncoderSpec(elements=[mk(2)]))
        port.encode_packets_device(cfg, bad, [music_pcm(F, 6, 16, seed=11)], device="cpu")


def test_forced_escape(jax_impl):
    cfg = make_config(depth=24, channels=2, frame_length=F)
    assert_equal_and_lossless(cfg, spec_for(4, escape=True), [music_pcm(F, 2, 24, seed=5)])


def test_kb0_goes_to_the_host_encoder(jax_impl):
    """Both packages route a kb == 0 cookie to their host encoder (the JAX
    package's Python one, the port's C++ core): equal bytes with pinned
    coefficients."""
    cfg = make_config(depth=16, channels=2, frame_length=F, kb=0)
    pcms = [music_pcm(F, 2, 16, seed=21), music_pcm(50, 2, 16, seed=22)]
    got, want = both(cfg, spec_for(4), pcms)
    assert got == want


# ---- fitting on: lossless, and as small as the JAX package's ----


@pytest.mark.parametrize(
    "depth,channels,order,bs",
    [(16, 2, 6, 0), (16, 1, 12, 0), (24, 2, 4, 1), (16, 2, 30, 0)],
    ids=["std6", "mono12", "bs24", "o30"],
)
def test_fit_on_lossless_and_size(jax_impl, depth, channels, order, bs):
    cfg = make_config(depth=depth, channels=channels, frame_length=256)
    pcms = [music_pcm(256, channels, depth, seed=30 + i, tonality=0.95) for i in range(6)]
    pcms.append(music_pcm(100, channels, depth, seed=40))
    pcms.append(music_pcm(20, channels, depth, seed=41))  # too short to fit: shared coefs
    spec = EncoderSpec(channel=ChannelSpec(order=order, fit=True), bytes_shifted=bs)
    got, want = both(cfg, spec, pcms)
    for pkt, pcm in zip(got, pcms):
        assert oracle(cfg, pkt)[0] == expected_pcm_bytes(pcm, depth)
    total, total_jax = sum(map(len, got)), sum(map(len, want))
    assert abs(total - total_jax) <= 0.01 * total_jax, (total, total_jax)


def _header_coefs(pkt: bytes, order: int, nch: int):
    """The initial coefficients in a full-frame compressed element's header:
    23 header bits, mixBits and mixRes, then per channel 16 bits of mode,
    denShift, pbFactor and numCoefs and ``order`` int16 coefficients."""
    bits = int.from_bytes(pkt, "big")
    total = len(pkt) * 8

    def field(pos, width):
        return (bits >> (total - pos - width)) & ((1 << width) - 1)

    out, pos = [], 23 + 16
    for _ in range(nch):
        pos += 16
        vals = [field(pos + 16 * k, 16) for k in range(order)]
        out.append([v - (1 << 16) if v >= (1 << 15) else v for v in vals])
        pos += 16 * order
    return out


@pytest.mark.parametrize("order", [4, 6, 12])
def test_fit_coefs_within_one_of_jax(jax_impl, order):
    """`fit_coefs` alone: float32 sums in another order may move a rounded
    coefficient by one step, not more (tolerance +-1)."""
    cfg = make_config(depth=16, channels=2, frame_length=256)
    pcms = [music_pcm(256, 2, 16, seed=50 + i, tonality=0.9) for i in range(4)]
    spec = EncoderSpec(channel=ChannelSpec(order=order, fit=True), mix_res=0, auto_escape=False)
    want = [_header_coefs(p, order, 2) for p in ed.encode_packets_device(cfg, spec, pcms)]
    shared = torch.zeros((4, 32), dtype=torch.int32)
    ns = torch.full((4,), 256)
    for c in range(2):
        d = torch.from_numpy(np.stack([p[:, c] for p in pcms]).astype(np.int32))
        got = ted.fit_coefs(d, ns, order, 9, shared)[:, :order].numpy()
        ref = np.array([w[c] for w in want])
        assert np.abs(ref).max() > 100
        assert np.abs(got - ref).max() <= 1


def test_fit_coefs_degenerate_lanes_keep_shared():
    d = torch.zeros((3, 64), dtype=torch.int32)
    d[1] = torch.arange(64)
    shared = torch.arange(32, dtype=torch.int32)[None, :].expand(3, 32)
    got = ted.fit_coefs(d, torch.tensor([64, 10, 64]), 4, 9, shared)
    assert torch.equal(got[0], shared[0]) and torch.equal(got[1], shared[1])  # silent; too short


# ---- the entry points and the host backend ----


def test_encode_packets_backends_agree_with_pinned_coefs():
    """`encoder.encode_packets`: the device backend (on CPU tensors), the
    C++ host core and the Python encoder write the same bytes given the
    same coefficients; a word that names no backend raises."""
    cfg = make_config(depth=16, channels=2, frame_length=F)
    pcm = music_pcm(3 * F + 40, 2, 16, seed=60)
    spec = port.EncoderSpec(channel=port.ChannelSpec(order=6, coefs=_COEFS[:6]))
    dev = port.encode_packets(cfg, spec, pcm, backend="cpu")
    assert len(dev) == 4
    assert dev == port.encode_packets(cfg, spec, pcm, backend="native")
    assert dev == port.encode_packets(cfg, spec, pcm, backend="python")
    with pytest.raises(ValueError):
        port.encode_packets(cfg, spec, pcm, backend="device")


def test_device_is_the_card_by_default():
    cfg = make_config(depth=16, channels=2, frame_length=64)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        port.encode_packets_device(cfg, port.EncoderSpec(), [music_pcm(64, 2, 16)])


def test_an_overflowed_lane_raises(monkeypatch):
    """A lane whose body outgrew its row is an error: no packet of the
    batch is quietly re-encoded on the host."""
    cfg = make_config(depth=16, channels=2, frame_length=64)
    real = ted.dense_encode

    def overflowing(*args, **kw):
        words, bits, ovf = real(*args, **kw)
        ovf[1] = 1
        return words, bits, ovf

    monkeypatch.setattr(ted, "dense_encode", overflowing)
    monkeypatch.setattr(native, "encode_with_spec", lambda *a: pytest.fail("host encoder called"))
    pcms = [music_pcm(64, 2, 16, seed=i) for i in range(3)]
    with pytest.raises(RuntimeError, match="overflowed its row on 1 lanes"):
        port.encode_packets_device(cfg, port.EncoderSpec(), pcms, device="cpu")


@pytest.mark.parametrize("order,fwd_channels", [(4, 2), (0, 0)])
def test_collected_calls_are_what_the_kernels_were_given(monkeypatch, order, fwd_channels):
    """`_calls` holds each kernel's arguments as the path built them: run
    again on their own they give the bodies the packets hold.  A stereo
    element's forward LPC is one launch over both channels' lanes (none at
    order 0), and so is its entropy encode (lanes channel-major, each
    reading its channel's row through the row map)."""
    from saprobe_alac_tpu_torch.ops import encode_kernel, lpc_kernel

    cfg = make_config(depth=16, channels=2, frame_length=64)
    spec = port.EncoderSpec(channel=port.ChannelSpec(order=order))
    pcms = [music_pcm(64, 2, 16, seed=i) for i in range(3)]
    monkeypatch.setattr(ted, "_calls", [])
    pkts = port.encode_packets_device(cfg, spec, pcms, device="cpu")
    names = [name for name, _, _ in ted._calls]
    assert names == ["encode_walk"] + ["lpc_forward"] * (fwd_channels > 0) + ["encode"]
    by = {n: [(a, kw) for m, a, kw in ted._calls if m == n] for n in set(names)}
    words, bits, ovf = ted.encode_walk(*by["encode_walk"][0][0], **by["encode_walk"][0][1])
    assert not ovf.any()
    assert [len(p) for p in pkts] == [(int(b) + 7) // 8 for b in bits[:3]]
    for fa, fkw in by.get("lpc_forward", []):
        r = lpc_kernel.lpc_fir(*fa, **fkw)[: cfg.frame_length].to(torch.int64)
        zigzag = torch.where(r >= 0, 2 * r, -2 * r - 1).to(torch.int32)
        (ea, ekw), = by["encode"]
        B = ea[2].shape[0] // 2
        assert zigzag.shape[1] == fwd_channels * B and torch.equal(zigzag, ea[0])
        assert torch.equal(ekw["row"], torch.arange(2 * B, dtype=torch.int32))
    for ea, ekw in by["encode"]:
        assert (encode_kernel.dense_encode(*ea, **ekw)[1][:3] > 0).all()
    monkeypatch.setattr(ted, "_calls", None)
    port.encode_packets_device(cfg, spec, pcms, device="cpu")  # collects nothing, and works


@pytest.mark.parametrize("channels", [1, 2, 3, 6, 8])
def test_one_forward_lpc_launch_per_element(monkeypatch, jax_impl, channels):
    """In every layout the forward LPC runs once per element, over all of
    its channels' lanes (channel-major), not once per channel; the packets
    equal the JAX package's and the C++ host encoder's with pinned
    coefficients."""
    from saprobe_alac_tpu_torch.codec.element import element_layout

    cfg = make_config(depth=16, channels=channels, frame_length=64)
    spec = spec_for(4, mix_res=1)
    pcms = [music_pcm(64, channels, 16, seed=80 + channels), music_pcm(41, channels, 16, seed=3)]
    monkeypatch.setattr(ted, "_calls", [])
    got = port.encode_packets_device(cfg, encoder_spec_from_jax(spec), pcms, device="cpu")
    fwd = [args for name, args, _ in ted._calls if name == "lpc_forward"]
    widths = element_layout(channels)
    assert [a[0].shape[0] for a in fwd] == widths  # one launch an element, its channels' rows
    assert [a[1].numel() for a in fwd] == [w * a[0].shape[2] for w, a in zip(widths, fwd)]
    assert got == ed.encode_packets_device(cfg, spec, pcms)
    assert got == native.encode_with_spec(cfg, encoder_spec_from_jax(spec), pcms)
    for pkt, pcm in zip(got, pcms):
        assert oracle(cfg, pkt)[0] == expected_pcm_bytes(pcm, cfg.bit_depth)


@pytest.mark.parametrize("case", ["elements", "pb_candidates", "wide_coefs"])
def test_native_raises_for_a_spec_it_cannot_express(case):
    cfg = make_config(depth=16, channels=6, frame_length=64)
    ch = port.ChannelSpec
    spec = {
        "elements": port.EncoderSpec(elements=[ch(order=2), ch(order=4), ch(order=4), ch(order=0)]),
        "pb_candidates": port.EncoderSpec(channel=ch(pb_candidates=(2, 4))),
        "wide_coefs": port.EncoderSpec(channel=ch(coefs=[40000, 0, 0, 0])),
    }[case]
    with pytest.raises(port.UnsupportedSpec):
        native.encode_with_spec(cfg, spec, [music_pcm(64, 6, 16, seed=1)])


def test_native_encode_with_spec_matches_jax_native():
    """The port's binding hands the core every field of a pinned spec (no
    fitting: the JAX package's Python encoder fits per channel, the core per
    packet): its packet is byte-equal to the JAX package's pure-Python
    encoder's, whose format the C++ core shares."""
    from saprobe_alac_tpu.encoder.encode import encode_packet as py_encode_packet

    cfg = make_config(depth=24, channels=2, frame_length=F)
    pcm = music_pcm(F, 2, 24, seed=70)
    spec = EncoderSpec(channel=ChannelSpec(order=8, mode=1, pb_factor=3, den_shift=10, fit=False),
                       bytes_shifted=1, mix_bits=2, mix_res=3)
    got = native.encode_with_spec(cfg, encoder_spec_from_jax(spec), [pcm])
    assert got == [py_encode_packet(cfg, spec, pcm)]


def test_port_encodes_with_jax_blocked():
    """With JAX and the JAX package both blocked, the port encodes a batch
    on CPU tensors and decodes it back to the source."""
    script = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["saprobe_alac_tpu"] = None
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import saprobe_alac_tpu_torch as port
        t = np.arange(200)
        cfg = port.PacketConfig(frame_length=64, bit_depth=16, num_channels=2, pb=40, mb=10,
                                kb=14, max_run=255, max_frame_bytes=0, avg_bit_rate=0,
                                sample_rate=44100)
        pcm = np.stack([(4000 * np.sin(t / 7)).astype(np.int64),
                        (4000 * np.sin(t / 5)).astype(np.int64)], 1)
        spec = port.EncoderSpec(channel=port.ChannelSpec(order=6, fit=True))
        pkts = port.encode_packets(cfg, spec, pcm, backend="cpu")
        dec = port.BatchDecoder(cfg, "cpu")
        assert b"".join(dec.decode_packets(pkts)) == pcm.astype("<i2").tobytes()
        assert dec.impl.last_fallbacks == 0
        print("OK")
        """
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=120, env=env
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
