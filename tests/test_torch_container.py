"""The port's host layers against the JAX package's, byte for byte:
magic-cookie parse, the error classes, the MP4 and CAF demux, the M4A and
CAF muxers, the encode API on the C++ core, and the WAV and PCM helpers.
Every input is made from a seed (`conftest.music_pcm`); the tolerance is 0
everywhere (equal fields, equal bytes, errors of the same class name)."""

import dataclasses
import inspect
import io
import struct

import numpy as np
import pytest

from conftest import make_config, music_pcm
from torch_files import alac_file

import saprobe_alac_tpu.errors as jax_errors
from saprobe_alac_tpu import caf as jax_caf
from saprobe_alac_tpu import config as jax_config
from saprobe_alac_tpu.encoder import EncoderSpec as JaxEncoderSpec
from saprobe_alac_tpu.encoder import api as jax_api
from saprobe_alac_tpu.encoder import mux as jax_mux
from saprobe_alac_tpu.formats import PCMFormat as JaxPCMFormat
from saprobe_alac_tpu.mp4 import find_alac_track as jax_find_alac_track
from saprobe_alac_tpu.utils import pcmconv as jax_pcmconv
from saprobe_alac_tpu.utils import wav as jax_wav
import saprobe_alac_tpu_torch as port
import saprobe_alac_tpu_torch.errors as port_errors
from saprobe_alac_tpu_torch import caf, encoder
from saprobe_alac_tpu_torch.encoder import mux
from saprobe_alac_tpu_torch.mp4 import find_alac_track
from saprobe_alac_tpu_torch.utils import pcmconv, wav

CONFIGS = [
    dict(depth=16, channels=2, frame_length=4096, sample_rate=44100),
    dict(depth=24, channels=6, frame_length=352, sample_rate=96000, kb=10, max_run=4),
    dict(depth=32, channels=1, frame_length=65535, sample_rate=192000, pb=255, mb=0),
]


def _wrapped(cookie: bytes, wrap: str) -> bytes:
    frma = struct.pack(">I4s4s", 12, b"frma", b"alac")
    alac = struct.pack(">I4sI", 12 + len(cookie), b"alac", 0)
    return {"bare": cookie, "alac": alac + cookie, "frma": frma + alac + cookie}[wrap]


def _outcome(fn, *args):
    """("ok", value) or ("raise", exception class name)."""
    try:
        return "ok", fn(*args)
    except Exception as exc:  # noqa: BLE001 — the class name is what is compared
        return "raise", type(exc).__name__


@pytest.mark.parametrize("wrap", ["bare", "alac", "frma"])
@pytest.mark.parametrize("kw", CONFIGS, ids=["s16", "c6_24", "m32"])
def test_parse_magic_cookie_matches_jax(kw, wrap):
    cfg = make_config(**kw)
    cookie = _wrapped(cfg.to_cookie(), wrap)
    got = port.parse_magic_cookie(cookie)
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_config.parse_magic_cookie(cookie))
    assert got.to_cookie() == cfg.to_cookie()
    assert hash(got) == hash(port.PacketConfig(**dataclasses.asdict(cfg)))


@pytest.mark.parametrize(
    "cookie",
    [
        b"",
        make_config().to_cookie()[:23],
        _wrapped(make_config().to_cookie()[:20], "frma"),
        make_config().to_cookie()[:4] + b"\x01" + make_config().to_cookie()[5:],
        _wrapped(make_config().to_cookie()[:4] + b"\x07" + make_config().to_cookie()[5:], "alac"),
    ],
    ids=["empty", "short", "short_wrapped", "version1", "version7_wrapped"],
)
def test_bad_cookie_raises_same_class(cookie):
    want = _outcome(jax_config.parse_magic_cookie, cookie)
    assert want[0] == "raise"
    assert _outcome(port.parse_magic_cookie, cookie) == want


def test_error_classes_match_jax():
    """Every class of the JAX package's errors module exists in the port
    with the same bases, by name."""
    for name, cls in inspect.getmembers(jax_errors, inspect.isclass):
        if cls.__module__ != jax_errors.__name__:
            continue
        mine = getattr(port_errors, name)
        assert [b.__name__ for b in mine.__mro__] == [b.__name__ for b in cls.__mro__]


def _co64(m4a: bytes) -> bytes:
    """The file with its stco box rewritten as co64 (every ancestor resized,
    every offset moved by the growth)."""
    idx = m4a.find(b"stco")
    size = struct.unpack(">I", m4a[idx - 4 : idx])[0]
    count = struct.unpack(">I", m4a[idx + 8 : idx + 12])[0]
    offsets = struct.unpack(f">{count}I", m4a[idx + 12 : idx + 12 + 4 * count])
    delta = 4 * count
    box = (struct.pack(">I", size + delta) + b"co64" + m4a[idx + 4 : idx + 12]
           + b"".join(struct.pack(">Q", o + delta) for o in offsets))
    out = bytearray(m4a[: idx - 4] + box + m4a[idx - 4 + size :])
    for four in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
        j = out.find(four)
        out[j - 4 : j] = struct.pack(">I", struct.unpack(">I", out[j - 4 : j])[0] + delta)
    return bytes(out)


def _multitrack(m4a: bytes) -> bytes:
    """The file with a non-ALAC trak spliced in before the ALAC one."""
    trak_idx = m4a.find(b"trak", m4a.find(b"moov"))
    stbl = struct.pack(">I", 8) + b"stbl"
    minf = struct.pack(">I", 8 + len(stbl)) + b"minf" + stbl
    mdia = struct.pack(">I", 8 + len(minf)) + b"mdia" + minf
    dummy = struct.pack(">I", 8 + len(mdia)) + b"trak" + mdia
    out = bytearray(m4a[: trak_idx - 4] + dummy + m4a[trak_idx - 4 :])
    j = out.find(b"moov")
    out[j - 4 : j] = struct.pack(">I", struct.unpack(">I", out[j - 4 : j])[0] + len(dummy))
    k = bytes(out).find(b"stco")
    for c in range(struct.unpack(">I", out[k + 8 : k + 12])[0]):
        p = k + 12 + 4 * c
        out[p : p + 4] = struct.pack(">I", struct.unpack(">I", out[p : p + 4])[0] + len(dummy))
    return bytes(out)


@pytest.mark.parametrize("layout", ["stco", "co64", "multitrack", "wrapped"])
def test_find_alac_track_matches_jax(layout):
    f = alac_file(frame=256, n=7 * 256 + 19, seed=3, wrap_cookie=layout == "wrapped")
    blob = {"co64": _co64, "multitrack": _multitrack}.get(layout, bytes)(f.blob)
    if layout == "co64":
        assert b"co64" in blob and b"stco" not in blob
    cookie, samples = find_alac_track(io.BytesIO(blob))
    want_cookie, want = jax_find_alac_track(io.BytesIO(blob))
    assert cookie == want_cookie
    assert [(s.offset, s.size) for s in samples] == [(s.offset, s.size) for s in want]
    assert [blob[s.offset : s.offset + s.size] for s in samples] == f.packets


@pytest.mark.parametrize("depth,channels,bs", [(16, 2, 0), (24, 6, 1)])
def test_caf_demux_matches_jax(depth, channels, bs):
    f = alac_file(depth=depth, channels=channels, frame=128, n=5 * 128 + 40, seed=4,
                  bytes_shifted=bs, container="caf")
    assert caf.sniff_container(f.reader()) == jax_caf.sniff_container(f.reader()) == "caf"
    cookie, samples = caf.find_alac_track_caf(f.reader())
    want_cookie, want = jax_caf.find_alac_track_caf(f.reader())
    assert cookie == want_cookie
    assert [(s.offset, s.size) for s in samples] == [(s.offset, s.size) for s in want]
    config, samples2 = port.demux_stream(f.reader())
    assert config == f.port_config and samples2 == samples


@pytest.mark.parametrize("head", [b"", b"garbage data here", b"\0\0\0\x08wide", b"caff\0\1\0\0"])
def test_sniff_container_matches_jax(head):
    assert caf.sniff_container(io.BytesIO(head)) == jax_caf.sniff_container(io.BytesIO(head))


@pytest.mark.parametrize("spp", ["given", "none"])
@pytest.mark.parametrize("kind", ["m4a", "m4a_wrapped", "caf"])
def test_muxers_byte_equal_to_jax(kind, spp):
    f = alac_file(depth=24, channels=2, frame=256, n=6 * 256 + 100, seed=5, bytes_shifted=1)
    s = f.spp if spp == "given" else None
    if kind == "caf":
        got = caf.build_caf(f.port_config, f.packets, s)
        want = jax_caf.build_caf(f.config, f.packets, s)
    else:
        wrap = kind == "m4a_wrapped"
        got = mux.build_m4a(f.port_config, f.packets, s, wrap_cookie=wrap)
        want = jax_mux.build_m4a(f.config, f.packets, s, wrap_cookie=wrap)
    assert got == want


def test_write_m4a_matches_build(tmp_path):
    f = alac_file(n=600, seed=6)
    path = tmp_path / "clip.m4a"
    mux.write_m4a(str(path), f.port_config, f.packets, f.spp)
    assert path.read_bytes() == f.blob


@pytest.mark.parametrize("container", ["m4a", "caf"])
@pytest.mark.parametrize("depth,channels,bs", [(16, 2, 0), (24, 2, 1), (20, 1, 0), (16, 6, 0)])
def test_encode_to_m4a_native_byte_equal_to_jax(depth, channels, bs, container):
    """Both packages run the same C++ encoder under the same spec."""
    pcm = music_pcm(3 * 512 + 77, channels, depth, seed=depth + channels)
    fmt = port.PCMFormat(48000, depth, channels)
    got = encoder.encode_to_m4a(fmt, pcm, frame_length=512, spec=port.EncoderSpec(bytes_shifted=bs),
                                container=container, backend="native")
    want = jax_api.encode_to_m4a(JaxPCMFormat(48000, depth, channels), pcm, frame_length=512,
                                 spec=JaxEncoderSpec(bytes_shifted=bs), container=container)
    assert got == want


def test_encode_wav_to_m4a_native_byte_equal_to_jax():
    fmt = port.PCMFormat(22050, 16, 2)
    pcm = music_pcm(2000, 2, 16, seed=8)
    buf = io.BytesIO()
    wav.write_wav(buf, fmt, pcmconv.array_to_pcm_bytes(fmt, pcm))
    data = buf.getvalue()
    got = encoder.encode_wav_to_m4a(io.BytesIO(data), frame_length=1024, backend="native")
    assert got == jax_api.encode_wav_to_m4a(io.BytesIO(data), frame_length=1024)
    cfg = encoder.make_packet_config(fmt, frame_length=1024)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_api.make_packet_config(JaxPCMFormat(22050, 16, 2), frame_length=1024))


@pytest.mark.parametrize("depth,channels", [(16, 2), (20, 1), (24, 6), (32, 2)])
def test_pcm_and_wav_helpers_match_jax(depth, channels):
    fmt, jfmt = port.PCMFormat(44100, depth, channels), JaxPCMFormat(44100, depth, channels)
    pcm = music_pcm(301, channels, depth, seed=depth)
    data = pcmconv.array_to_pcm_bytes(fmt, pcm)
    assert data == jax_pcmconv.array_to_pcm_bytes(jfmt, pcm)
    assert np.array_equal(pcmconv.pcm_bytes_to_array(fmt, data), pcm)
    assert np.array_equal(pcmconv.pcm_bytes_to_array(fmt, data + b"\1"),
                          jax_pcmconv.pcm_bytes_to_array(jfmt, data + b"\1"))
    assert wav.wav_header(fmt, len(data)) == jax_wav.wav_header(jfmt, len(data))
    buf = io.BytesIO()
    wav.write_wav(buf, fmt, data)
    got_fmt, got_data = wav.read_wav(io.BytesIO(buf.getvalue()))
    want_fmt, want_data = jax_wav.read_wav(io.BytesIO(buf.getvalue()))
    assert (dataclasses.asdict(got_fmt), got_data) == (dataclasses.asdict(want_fmt), want_data)
    assert got_data == data  # a 20-bit stream reads back as its 24-bit container
    assert port.bytes_per_sample(depth) == len(data) // pcm.size


@pytest.mark.parametrize(
    "blob",
    [
        b"RIFF\0\0\0\0WAVX",
        b"RIFF\0\0\0\0WAVEdata\4\0\0\0\0\0\0\0",
        b"RIFF\0\0\0\0WAVEfmt \x10\0\0\0\3\0\1\0\x44\xac\0\0\0\0\0\0\4\0\x20\0",
        b"RIFF\0\0\0\0WAVEjunk\2\0\0\0ab",
    ],
    ids=["not_wave", "data_first", "float", "no_data"],
)
def test_read_wav_errors_match_jax(blob):
    want = _outcome(jax_wav.read_wav, io.BytesIO(blob))
    assert want[0] == "raise"
    assert _outcome(wav.read_wav, io.BytesIO(blob)) == want


def _truncate_moov(blob):
    return blob[: blob.find(b"stsz") + 6]


def _drop_alac(blob):
    i = blob.find(b"alac", blob.find(b"stsd"))
    return blob[:i] + b"mp4a" + blob[i + 4 :]


def _bad_box_size(blob):
    i = blob.find(b"moov")
    return blob[: i - 4] + struct.pack(">I", 3) + blob[i:]


def _no_stsz(blob):
    i = blob.find(b"stsz")
    return blob[:i] + b"xxxx" + blob[i + 4 :]


def _caf_no_pakt(blob):
    i = blob.find(b"pakt")
    return blob[:i] + b"free" + blob[i + 4 :]


def _caf_not_alac(blob):
    i = blob.find(b"alac")
    return blob[:i] + b"lpcm" + blob[i + 4 :]


@pytest.mark.parametrize(
    "container,corrupt",
    [
        ("m4a", lambda b: b"garbage data here"),
        ("m4a", lambda b: b""),
        ("m4a", _truncate_moov),
        ("m4a", _drop_alac),
        ("m4a", _bad_box_size),
        ("m4a", _no_stsz),
        ("caf", lambda b: b[:40]),
        ("caf", _caf_no_pakt),
        ("caf", _caf_not_alac),
    ],
    ids=["garbage", "empty", "truncated_moov", "no_alac_entry", "bad_box_size", "no_stsz",
         "caf_truncated", "caf_no_pakt", "caf_not_alac"],
)
def test_bad_containers_raise_same_class(container, corrupt):
    """Truncated and ALAC-less files raise the port's class of the JAX
    package's name, a NoTrackError (or, where the JAX package raises
    another class, that one)."""
    from saprobe_alac_tpu.decode import demux_stream as jax_demux

    blob = corrupt(alac_file(frame=128, n=700, seed=9, container=container).blob)
    want = _outcome(jax_demux, io.BytesIO(blob))
    assert want[0] == "raise"
    assert _outcome(port.demux_stream, io.BytesIO(blob)) == want
