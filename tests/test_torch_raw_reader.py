"""The port's raw reader and shift-region extraction against the JAX package.

`raw_read_reference` (the plain version the CPU runs, and the CUDA kernel's
yardstick) against `raw_read_pallas` in interpret mode on random words:
every width the shift region uses and the 32-bit edge, signed and unsigned
reads, inactive lanes, lanes with n < F and fields that run past the last
column.  Then `extract_shift` on real walk outputs against the JAX
package's `extract_shift_kernel` (Pallas raw reader, interpret mode) and its
XLA `extract_shift`.  Tolerance 0 (integer code).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_config, music_pcm

from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
from saprobe_alac_tpu.ops.epilogue import extract_shift as jax_extract_shift
from saprobe_alac_tpu.ops.epilogue import extract_shift_kernel
from saprobe_alac_tpu.ops.walk_kernel import raw_read_pallas
from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder
from saprobe_alac_tpu_torch.ops.epilogue import extract_shift
from saprobe_alac_tpu_torch.ops.raw_reader import raw_read, raw_read_reference
from saprobe_alac_tpu_torch.ops.walk import walk_batch

B = 128
F = 200
W = 420


def _lanes(width, seed):
    """Random words and per-lane fields: steps of 1-2 field widths, a fifth
    of the lanes inactive, n from 0 to F, and eight lanes whose last fields
    end near or past the last column (those read zeros past it)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-(2**31), 2**31, size=(B, W), dtype=np.int64).astype(np.int32)
    step = rng.integers(width, 2 * width + 1, size=B).astype(np.int32)
    n = rng.integers(0, F + 1, size=B).astype(np.int32)
    n[:8] = F
    act = (rng.random(B) < 0.8).astype(np.int32)
    act[:8] = 1
    base = rng.integers(0, 64, size=B)
    base[:8] = W * 32 - n[:8] * step[:8] + rng.integers(-40, 10, size=8)
    widths = np.full(B, width, np.int32)
    return words, np.maximum(base, 0).astype(np.int32), step, widths, act, n


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("width", [8, 16, 24, 32])
def test_raw_read_reference_matches_pallas(width, signed):
    words, base, step, widths, act, n = _lanes(width, seed=width + 100 * signed)
    want = np.asarray(
        raw_read_pallas(
            jnp.asarray(words.T), *(jnp.asarray(x) for x in (base, step, widths, act, n)),
            F=F, LB=128, signed=signed, interpret=True,
        )
    )
    args = [torch.from_numpy(x) for x in (words, base, step, widths, act, n)]
    got = raw_read(*args, F=F, signed=signed)
    assert got.shape == want.shape == (208, B) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:, torch.from_numpy(act == 0)].eq(0).all() and got[F:].eq(0).all()
    if signed:
        assert (got < 0).any()


def test_raw_read_rejects_other_devices():
    args = [torch.zeros((B, 4), dtype=torch.int32, device="meta")]
    args += [torch.zeros(B, dtype=torch.int32, device="meta")] * 5
    with pytest.raises(ValueError):
        raw_read(*args, F=F)


def _walk(depth, C, bsf, seed):
    """A packed batch of shifted music, near-white noise (escape elements,
    bs 0), a partial final packet and a truncated packet, with its walk.
    32-bit mono music is 24-bit content (>> 8): at full scale its residuals
    overflow the entropy coder and every packet becomes an escape."""
    Fw = 128
    cfg = make_config(depth=depth, channels=C, frame_length=Fw)
    spec = EncoderSpec(bytes_shifted=bsf)
    quiet = 8 if (depth, C) == (32, 1) else 0
    pk = encode_packets(cfg, spec, music_pcm(Fw * 90 + 41, C, depth, seed=seed) >> quiet)
    pk += encode_packets(cfg, spec, music_pcm(Fw * 36, C, depth, seed=seed + 1, tonality=0.0))
    pk = pk[: B - 1] + [pk[5][: len(pk[5]) // 3]]
    words, sizes = TorchBatchDecoder(cfg, "cpu")._stage(pk)
    w = walk_batch(words, sizes, F=Fw, C=C, depth=depth, pb=cfg.pb, mb=cfg.mb, kb=cfg.kb)
    return Fw, words, w


@pytest.mark.parametrize(
    "depth,C,bsf", [(24, 2, 1), (32, 2, 2), (24, 1, 1), (32, 1, 1)],
    ids=["cpe24bs1", "cpe32bs2", "sce24bs1", "sce32bs1"],
)
def test_extract_shift_matches_jax(depth, C, bsf):
    Fw, words, w = _walk(depth, C, bsf, seed=depth + C)
    assert (w.bs[:, 0] == bsf).sum() > B // 2 and (w.ns < Fw).any()
    got = extract_shift(words, w.shift_base, w.bs, w.role, w.ns, F=Fw, C=C).numpy()
    j = {k: jnp.asarray(getattr(w, k).numpy()) for k in ("shift_base", "bs", "role", "ns")}
    jw = jnp.asarray(words.numpy())
    want = np.asarray(
        extract_shift_kernel(jw, j["shift_base"], j["bs"], j["role"], j["ns"], Fw, C,
                             "pallas_interpret")
    )
    assert got.shape == want.shape == (Fw, C, words.shape[0])
    np.testing.assert_array_equal(got, want)
    # The XLA gather reads every row; rows past a packet's ns are trimmed.
    xla = np.asarray(jax_extract_shift(jw, j["shift_base"], j["bs"], j["role"], Fw, C))
    rows = np.arange(Fw)[:, None, None] < w.ns.numpy()[None, None, :]
    np.testing.assert_array_equal(np.where(rows, got, 0), np.where(rows, xla, 0))
    assert got.any()
