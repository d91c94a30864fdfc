"""Go-semantics integer helpers of the PyTorch port against ops/jaxint.py.

Bit-exact (tolerance 0): shift counts 0..40 across the 32-bit boundary,
sign-extension widths past 32, and the INT_MIN/INT_MAX corners.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saprobe_alac_tpu.ops import jaxint
from saprobe_alac_tpu_torch.ops import torchint

VALUES = np.array(
    [0, 1, -1, 2, -2, 3, 0x7FFF, -0x8000, 0xFFFF, 0x12345678, -0x12345678,
     2**31 - 1, -(2**31), 0x40000000, -0x40000000, 0x0F0F0F0F],
    dtype=np.int32,
)
COUNTS = [0, 1, 5, 16, 31, 32, 33, 40]


def _pair(x, n):
    xs = np.repeat(VALUES, len(n))
    ns = np.tile(np.array(n, dtype=np.int32), len(VALUES))
    return xs, ns


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", ["shl", "ushr", "sshr"])
def test_shifts_match_jaxint(name):
    xs, ns = _pair(VALUES, COUNTS)
    ref = getattr(jaxint, name)(jnp.asarray(xs), jnp.asarray(ns))
    got = getattr(torchint, name)(torch.from_numpy(xs), torch.from_numpy(ns))
    assert got.dtype == torch.int32
    _eq(got, ref)


def test_sext_matches_jaxint():
    xs, bits = _pair(VALUES, [1, 8, 16, 31, 32, 33])
    ref = jaxint.sext(jnp.asarray(xs), jnp.asarray(bits))
    _eq(torchint.sext(torch.from_numpy(xs), torch.from_numpy(bits)), ref)
    _eq(torchint.sext16(torch.from_numpy(VALUES)), jaxint.sext16(jnp.asarray(VALUES)))


def test_clz_lg3a_match_jaxint():
    x = torch.from_numpy(VALUES)
    _eq(torchint.clz(x), jaxint.clz(jnp.asarray(VALUES)))
    _eq(torchint.lg3a(x), jaxint.lg3a(jnp.asarray(VALUES)))
    assert int(torchint.clz(torch.tensor([0], dtype=torch.int32))[0]) == 32


def test_int64_inputs_keep_int32_values():
    # The walk's plain version holds int32 values in int64 tensors.
    xs, ns = _pair(VALUES, COUNTS)
    got = torchint.shl(torch.from_numpy(xs).long(), torch.from_numpy(ns))
    assert got.dtype == torch.int64
    _eq(got.int(), jaxint.shl(jnp.asarray(xs), jnp.asarray(ns)))


def test_vread_matches_streambits():
    """Reads inside the row and past its end (guard words read zero)."""
    from saprobe_alac_tpu.ops.bitpack import pack_packets
    from saprobe_alac_tpu.ops.streambits import vread as jax_vread
    from saprobe_alac_tpu_torch.ops.streambits import vread

    rng = np.random.default_rng(3)
    pkts = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in (5, 17, 40)]
    words, _ = pack_packets(pkts)
    W = words.shape[1]
    pos = rng.integers(0, 32 * W - 8, size=(3,)).astype(np.int32)
    for n in (1, 3, 16, 31, 32):
        for p in (pos, np.array([0, 37, 32 * (W - 1)], np.int32)):
            ref = jax_vread(jnp.asarray(words), jnp.asarray(p), n)
            _eq(vread(torch.from_numpy(words), torch.from_numpy(p), n).int(), ref)
