"""The port's CLI (`python -m saprobe_alac_tpu_torch.cli`: alac-decode and
alac-encode) against the JAX package's, byte for byte, on the CPU: PCM and
WAV output equal to the JAX CLI's (``-backend native``) and to the source,
stdin to stdout, ``-version``, a bad and a missing file (rc 1 and the same
message), and alac-encode round trips into M4A and CAF."""

import io
import subprocess
import sys

import pytest
import torch

from torch_files import alac_file

from saprobe_alac_tpu import cli as jax_cli
from saprobe_alac_tpu_torch import PCMFormat, cli
from saprobe_alac_tpu_torch.utils.pcmconv import array_to_pcm_bytes
from saprobe_alac_tpu_torch.utils.wav import read_wav, wav_header, write_wav

from conftest import music_pcm


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    f = alac_file(depth=24, channels=2, frame=128, n=5 * 128 + 71, seed=21, bytes_shifted=1)
    path = tmp_path_factory.mktemp("cli") / "clip.m4a"
    path.write_bytes(f.blob)
    return path, f


def _run(main, argv, capsysbinary, stdin=None, monkeypatch=None):
    """(rc, stdout bytes, stderr bytes) of one in-process CLI call."""
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(stdin)))
    rc = main(argv)
    out = capsysbinary.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("backend", ["cpu", "native"])
@pytest.mark.parametrize("fmt", ["pcm", "wav"])
def test_decode_matches_jax_cli(clip, tmp_path, capsysbinary, fmt, backend):
    path, f = clip
    mine, ref = tmp_path / "mine", tmp_path / "ref"
    rc, _, err = _run(cli.main, ["-format", fmt, "-backend", backend, "-batch", "4", str(path),
                                 str(mine)], capsysbinary)
    assert rc == 0, err
    assert b"44100 Hz, 24-bit, 2 ch" in err
    assert _run(jax_cli.main, ["-format", fmt, "-backend", "native", str(path), str(ref)],
                capsysbinary)[0] == 0
    assert mine.read_bytes() == ref.read_bytes()
    if fmt == "wav":
        got_fmt, data = read_wav(io.BytesIO(mine.read_bytes()))
        assert mine.read_bytes()[:44] == wav_header(got_fmt, len(f.source))
    else:
        data = mine.read_bytes()
    assert data == f.source


def test_caf_to_stdout(tmp_path, capsysbinary):
    f = alac_file(depth=16, channels=2, frame=128, n=300, seed=22, container="caf")
    path = tmp_path / "clip.caf"
    path.write_bytes(f.blob)
    rc, out, err = _run(cli.main, ["-format", "pcm", "-backend", "cpu", str(path)], capsysbinary)
    assert rc == 0, err
    assert out == f.source


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_stdin_to_stdout(clip, capsysbinary, monkeypatch, backend):
    path, f = clip
    rc, out, err = _run(cli.main, ["-format", "wav", "-backend", backend, "-"], capsysbinary,
                        stdin=path.read_bytes(), monkeypatch=monkeypatch)
    assert rc == 0, err
    assert out[44:] == f.source and out[:44] == wav_header(PCMFormat(44100, 24, 2), len(f.source))


def test_module_runs_stdin_to_stdout(clip):
    """``python -m saprobe_alac_tpu_torch.cli`` as a process."""
    path, f = clip
    r = subprocess.run([sys.executable, "-m", "saprobe_alac_tpu_torch.cli", "-format", "pcm",
                        "-backend", "native", "-"], input=path.read_bytes(), capture_output=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout == f.source


@pytest.mark.parametrize("main,prog", [(cli.main, "alac-decode"), (cli.encode_main, "alac-encode")])
def test_version(main, prog, capsys):
    with pytest.raises(SystemExit) as done:
        main(["-version"])
    assert done.value.code == 0
    assert capsys.readouterr().out.strip() == f"{prog} 0.1.0"


@pytest.mark.parametrize("content", [b"garbage data here", None], ids=["bad", "missing"])
@pytest.mark.parametrize("which", ["decode", "encode"])
def test_bad_and_missing_files(tmp_path, capsysbinary, content, which):
    """rc 1 and the JAX CLI's message (the class and the text)."""
    path = tmp_path / "in.bin"
    if content is not None:
        path.write_bytes(content)
    mine_fn, ref_fn = {"decode": (cli.main, jax_cli.main),
                       "encode": (cli.encode_main, jax_cli.encode_main)}[which]
    rc, _, err = _run(mine_fn, ["-backend", "native", str(path), str(tmp_path / "o")],
                      capsysbinary)
    rc_ref, _, err_ref = _run(ref_fn, [str(path), str(tmp_path / "o")], capsysbinary)
    assert rc == rc_ref == 1
    assert err == err_ref and err.startswith(b"alac-")


@pytest.mark.parametrize("backend,container", [("cpu", "m4a"), ("cpu", "caf"), ("native", "m4a"),
                                               ("native", "caf"), ("python", "m4a")])
def test_encode_round_trip(tmp_path, capsysbinary, backend, container):
    """alac-encode WAV -> M4A/CAF -> alac-decode gives the WAV's PCM; the
    C++ core's files equal the JAX CLI's (and ``python``, the Python
    encoder, encodes too)."""
    fmt = PCMFormat(22050, 16, 2)
    pcm = music_pcm(3 * 256 + 70, 2, 16, seed=33)
    wav_in = tmp_path / "in.wav"
    with open(wav_in, "wb") as fh:
        write_wav(fh, fmt, array_to_pcm_bytes(fmt, pcm))
    out = tmp_path / f"out.{container}"
    rc, _, err = _run(cli.encode_main, ["-frame", "256", "-container", container, "-backend",
                                        backend, str(wav_in), str(out)], capsysbinary)
    assert rc == 0, err
    if backend == "native":
        ref = tmp_path / "ref"
        assert _run(jax_cli.encode_main, ["-frame", "256", "-container", container, str(wav_in),
                                          str(ref)], capsysbinary)[0] == 0
        assert out.read_bytes() == ref.read_bytes()
    rc, pcm_out, err = _run(cli.main, ["-format", "pcm", "-backend", "cpu", "-batch", "8",
                                       str(out)], capsysbinary)
    assert rc == 0, err
    assert pcm_out == array_to_pcm_bytes(fmt, pcm)


def test_cli_raises_without_a_card(clip):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default backend runs on it")
    path, _ = clip
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-format", "pcm", str(path), str(path.with_suffix(".pcm"))])
