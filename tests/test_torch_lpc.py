"""The port's LPC (plain version) against the JAX package's `_lpc_batch`.

Both sides reconstruct from the same walk output, carried across with
`interop`: the JAX xla walk's residuals feed both LPCs, and the port's walk
rows feed both LPCs.  Bit for bit (tolerance 0) for t < ns on lanes that
decoded without error; orders 0, 1, 4, 8, 12, 30 and 31 and mode 1, plus
one 9-tap case against the Pallas LPC kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_config, music_pcm

from saprobe_alac_tpu.encoder import ChannelSpec, EncoderSpec, encode_packets
from saprobe_alac_tpu.ops import walk as jwalk
from saprobe_alac_tpu.ops.bitpack import pack_packets
from saprobe_alac_tpu.ops.epilogue import extract_escape
from saprobe_alac_tpu.ops.lpc import _lpc_batch
from saprobe_alac_tpu_torch import interop
from saprobe_alac_tpu_torch.ops.lpc import lpc_batch
from saprobe_alac_tpu_torch.ops.walk import walk_batch

F = 256
C = 2

SPECS = {
    "o0": ChannelSpec(order=0),
    "o1": ChannelSpec(order=1),
    "o4": ChannelSpec(order=4),
    "o8": ChannelSpec(order=8),
    "o12": ChannelSpec(order=12),
    "o30": ChannelSpec(order=30),
    "o31": ChannelSpec(order=31),
    "o12_mode1": ChannelSpec(order=12, mode=1),
}


def _taps(order):
    return 32 if ((order >= 9) & (order <= 30)).any() else 9


def _case(name):
    cfg = make_config(depth=16, channels=C, frame_length=F)
    pcm = music_pcm(2 * F + 57, C, 16, seed=len(name))
    pkts = encode_packets(cfg, EncoderSpec(channel=SPECS[name]), pcm)
    words, sizes = pack_packets(pkts)
    return cfg, words, sizes


def _jax_walk_inputs(cfg, words, sizes):
    """JAX xla walk -> the (F, L) residuals and lane arrays `_lpc_batch`
    takes (lane = c*B + b), as numpy."""
    w = jwalk._walk_batch(
        jnp.asarray(words), jnp.asarray(sizes), F, C, 16, cfg.pb, cfg.mb, cfg.kb, "xla"
    )
    res = extract_escape(jnp.asarray(words), w.res, w.esc, w.esc_base, w.esc_cb, w.role, F, C)
    L = words.shape[0] * C
    lanes = [np.asarray(getattr(w, n)).T.reshape(L) for n in ("order", "mode", "den", "cb")]
    ns = np.tile(np.asarray(w.ns), C)
    coefs = np.asarray(w.coefs).transpose(1, 0, 2).reshape(L, 32)
    ok = np.tile(np.asarray(w.err) == 0, C) & (np.asarray(w.filled).T.reshape(L) == 1)
    return np.asarray(res).reshape(F, L), lanes, ns, coefs, ok


def _port_walk_inputs(cfg, words, sizes):
    w = walk_batch(torch.from_numpy(words), torch.from_numpy(sizes), F=F, C=C,
                   depth=16, pb=cfg.pb, mb=cfg.mb, kb=cfg.kb)
    L = words.shape[0] * C
    res = w.res.numpy()[:, :F].transpose(1, 0, 2).reshape(F, L)
    lanes = [getattr(w, n).numpy().T.reshape(L) for n in ("order", "mode", "den", "cb")]
    ns = np.tile(w.ns.numpy(), C)
    coefs = w.coefs.numpy().transpose(1, 0, 2).reshape(L, 32)
    ok = np.tile(w.err.numpy() == 0, C) & (w.filled.numpy().T.reshape(L) == 1)
    return w, res, lanes, ns, coefs, ok


def _jax_lpc(res, lanes, ns, coefs, impl, taps=None):
    order, mode, den, cb = (jnp.asarray(x) for x in lanes)
    out = _lpc_batch(jnp.asarray(res), order, mode, den, cb, jnp.asarray(ns),
                     jnp.asarray(coefs), F, impl, taps=taps)
    return np.asarray(out)


def _assert_equal(got, want, ns, ok):
    live = (np.arange(F)[:, None] < ns[None, :]) & ok[None, :]
    bad = np.argwhere((got != want) & live)
    assert bad.size == 0, f"LPC output differs at {bad[:5].tolist()}"
    assert live.any()


@pytest.mark.parametrize("name", list(SPECS))
def test_lpc_matches_xla_on_jax_walk(name):
    cfg, words, sizes = _case(name)
    res, lanes, ns, coefs, ok = _jax_walk_inputs(cfg, words, sizes)
    want = _jax_lpc(res, lanes, ns, coefs, "xla")
    inputs = interop.lpc_inputs_from_jax(res, *lanes, ns, coefs, F)
    got = lpc_batch(*inputs, F=F, taps=_taps(lanes[0])).numpy()
    _assert_equal(got, want, ns, ok)


@pytest.mark.parametrize("name", ["o4", "o12", "o31", "o12_mode1"])
def test_lpc_matches_xla_on_port_walk(name):
    """The port's LPC reads the walk's rows in place (lane = c*B + b)."""
    cfg, words, sizes = _case(name)
    w, res, lanes, ns, coefs, ok = _port_walk_inputs(cfg, words, sizes)
    want = _jax_lpc(res, lanes, ns, coefs, "xla")
    L = words.shape[0] * C
    got = lpc_batch(
        w.res, w.order.T.reshape(L), w.mode.T.reshape(L), w.den.T.reshape(L),
        w.cb.T.reshape(L), w.ns.repeat(C), w.coefs.transpose(0, 1).reshape(L, 32),
        F=F, taps=_taps(lanes[0]),
    ).numpy()
    _assert_equal(got, want, ns, ok)


def test_lpc_taps9_matches_pallas_kernel():
    cfg, words, sizes = _case("o8")
    res, lanes, ns, coefs, ok = _jax_walk_inputs(cfg, words, sizes)
    want = _jax_lpc(res, lanes, ns, coefs, "pallas_interpret", taps=9)
    inputs = interop.lpc_inputs_from_jax(res, *lanes, ns, coefs, F)
    got = lpc_batch(*inputs, F=F, taps=9).numpy()
    _assert_equal(got, want, ns, ok)
