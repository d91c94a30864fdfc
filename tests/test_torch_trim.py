"""The batch decoder's trim to ``bytes`` (`TorchBatchDecoder.finish_async`:
`native.rows_to_bytes` from `NATIVE_TRIM_BYTES` in all, `_to_bytes` a row
below), on the CPU.

Each device-decoded packet's PCM is the first ns * C * bytes-a-sample bytes
of its row of `finish_packed`'s output, in every layout: 16-bit int32 pairs
(even C) or int16 samples (odd C), 20/24-bit int32 words of four 3-byte
samples (F*C % 4 == 0) or uint8 triples, 32-bit int32 samples.  Rows are
synthetic here (the layouts' decodes are held in test_torch_batch*.py);
the reference is a plain slice of each row, and error lanes take the host
decode of their packets, in place.
"""

import ctypes
import functools
import sys

import numpy as np
import pytest
import torch

from conftest import music_pcm

import saprobe_alac_tpu_torch as port
from saprobe_alac_tpu_torch import native
from saprobe_alac_tpu_torch.ops import batch, program
from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder

#: Not a multiple of 4, so odd C at 20/24 bits has F*C % 4 != 0.
F = 4094
#: Every lane cycles through these sample counts.
NS = (0, 1, F - 1, F)
#: Each FALLBACK-th lane is flagged by the walk and decodes on the host.
FALLBACK = 5


def _config(depth, channels):
    return port.PacketConfig(F, depth, channels, 40, 10, 14, 255, 0, 0, 48000)


@functools.cache
def _packets(depth, channels):
    """Two real packets of the config, for the lanes the host decodes."""
    cfg = _config(depth, channels)
    pcm = music_pcm(2 * F, channels, depth, seed=depth * 8 + channels)
    spec = port.EncoderSpec(channel=port.ChannelSpec(order=4))
    return port.encode_packets(cfg, spec, pcm, backend="native")


def _rows(depth, channels, n, seed):
    """Random rows in `finish_packed`'s layout of (depth, C) at F."""
    g = torch.Generator().manual_seed(seed)
    if depth == 16 and channels % 2 == 0:
        shape, dtype = (n, F * channels // 2), torch.int32
    elif depth == 16:
        shape, dtype = (n, F * channels), torch.int16
    elif depth in (20, 24) and (F * channels) % 4 == 0:
        shape, dtype = (n, F * channels * 3 // 4), torch.int32
    elif depth in (20, 24):
        shape, dtype = (n, F * channels * 3), torch.uint8
    else:
        shape, dtype = (n, F * channels), torch.int32
    lo, hi = (0, 256) if dtype == torch.uint8 else (torch.iinfo(dtype).min, torch.iinfo(dtype).max)
    return torch.randint(lo, hi, shape, dtype=dtype, generator=g)


def _slice(row: np.ndarray, ns: int, depth: int, channels: int) -> bytes:
    """The plain per-row trim: the row's first ns samples of every channel."""
    if depth == 16:
        return row[: ns * channels // 2 if channels % 2 == 0 else ns * channels].tobytes()
    if depth in (20, 24):
        nb = ns * channels * 3
        if (F * channels) % 4 == 0:
            return row[: (nb + 3) // 4].tobytes()[:nb]
        return row[:nb].tobytes()
    return row[: ns * channels].tobytes()


def _lanes(side, depth, channels):
    """Lanes of a batch whose device-decoded bytes add up to under or over
    the threshold of the native trim."""
    row = F * channels * native.BYTES_PER_SAMPLE[depth]
    if side == "rows":
        return 6
    return 3 * (batch.NATIVE_TRIM_BYTES // row) + 12


@pytest.mark.parametrize("source", ["buffer", "numpy"])
@pytest.mark.parametrize("side", ["rows", "native"])
@pytest.mark.parametrize("channels", [1, 2, 3, 6, 8])
@pytest.mark.parametrize("depth", [16, 20, 24, 32])
def test_trim_matches_a_plain_slice(depth, channels, side, source, monkeypatch):
    """Every packet is exactly ``bytes``, a distinct object equal to the
    plain slice of its row (the host decode of its packet on an error
    lane), in packet order; rows from a prefix of a reused uint8 buffer
    (pinned where a card is), as the card's download gives them, or from a
    plain numpy array, as the CPU device gives them.  Under the threshold
    no call goes into the core."""
    cfg = _config(depth, channels)
    n = _lanes(side, depth, channels)
    rows = _rows(depth, channels, n + 3, seed=n)  # rows past n: the bucket's padding
    ns = torch.tensor([NS[i % len(NS)] for i in range(n + 3)], dtype=torch.int32)
    err = torch.zeros(n + 3, dtype=torch.int32)
    fb = list(range(2, n, FALLBACK))
    err[fb] = 1
    real = _packets(depth, channels)
    packets = [real[k % 2] if k in fb else b"" for k in range(n)]

    dec = TorchBatchDecoder(cfg, "cpu")
    if source == "buffer":
        pin = torch.cuda.is_available()
        buf = torch.empty(rows.numel() * rows.element_size() + 4096, dtype=torch.uint8,
                          pin_memory=pin)
        view = buf[: rows.numel() * rows.element_size()].view(rows.dtype).view(rows.shape)
        view.copy_(rows)
        monkeypatch.setattr(dec, "_download", lambda t: (view.numpy(), buf))
    threads = []
    fill = native.rows_to_bytes

    def counted(r, lengths, spare=None):
        out, t = fill(r, lengths, spare)
        threads.append((t, int(lengths.sum())))
        return out, t

    monkeypatch.setattr(native, "rows_to_bytes", counted)
    out = dec.finish_async((rows, err, ns, torch.zeros(n + 3, dtype=torch.bool)), packets)

    host = port.BatchDecoder(cfg, "native")
    want = [host.decode_packets([packets[k]])[0] if k in fb
            else _slice(rows[k].numpy(), int(ns[k]), depth, channels) for k in range(n)]
    assert len(out) == n and all(type(b) is bytes for b in out)
    assert out == want
    full = [b for b in out if b]
    assert len({id(b) for b in full}) == len(full)
    assert dec.last_fallbacks == len(fb)
    copied = sum(len(want[k]) for k in range(n) if k not in fb)
    if side == "rows":
        assert threads == [] and copied < batch.NATIVE_TRIM_BYTES
    else:
        ((t, total),) = threads
        assert total == copied >= batch.NATIVE_TRIM_BYTES and t >= 1


def test_rows_to_bytes_refuses_lengths_past_a_row():
    """A length past its row's bytes or below 0 raises before anything is
    written; an empty batch gives an empty list."""
    rows = np.zeros((3, 10), np.int16)
    for bad in ([0, 21, 0], [0, -1, 0], [0, 0]):
        with pytest.raises(ValueError):
            native.rows_to_bytes(rows, np.array(bad))
    assert native.rows_to_bytes(rows[:0], np.zeros(0, np.int64))[0] == []
    got, _ = native.rows_to_bytes(rows[:, ::2], np.array([10, 0, 3]))
    assert got == [bytes(10), b"", bytes(3)]


def test_trim_bytes_counts_every_call():
    """``trim_bytes`` adds each call's copied bytes on the CPU device."""
    cfg = _config(16, 2)
    rows = _rows(16, 2, 4, seed=1)
    ns = torch.tensor([F, 3, 0, F], dtype=torch.int32)
    zero = torch.zeros(4, dtype=torch.int32)
    program.reset_counts()
    dec = TorchBatchDecoder(cfg, "cpu")
    out = dec.finish_async((rows, zero, ns, zero.bool()), [b""] * 4)
    dec.finish_async((rows, zero, ns, zero.bool()), [b""] * 2)
    assert [len(b) for b in out] == [4 * F, 12, 0, 4 * F]
    assert program.counts("cpu")["trim_bytes"] == (8 * F + 12) + (4 * F + 12)


def test_rows_to_bytes_keeps_its_own_prototypes(monkeypatch):
    """The binding leaves ``ctypes.pythonapi``'s shared prototypes as they
    are, and what another module sets on them does not reach it."""
    api = ctypes.pythonapi
    assert api.PyBytes_FromStringAndSize.restype is ctypes.c_int
    assert api.PyBytes_AsString.restype is ctypes.c_int
    monkeypatch.setattr(api.PyBytes_FromStringAndSize, "restype", ctypes.c_void_p)
    rows = np.arange(40, dtype=np.uint8).reshape(2, 20)
    got, _ = native.rows_to_bytes(rows, np.array([20, 7]))
    assert got == [bytes(range(20)), bytes(range(20, 27))]
    assert all(type(b) is bytes for b in got)


@pytest.mark.parametrize("spares", [0, 2, 3, 6])
def test_rows_to_bytes_makes_its_outputs_as_it_drops_the_spares(spares):
    """The spare outputs handed in are all let go (the list is emptied),
    fewer or more than the new ones, and an earlier output the caller
    still holds keeps its bytes; the new outputs are the rows' bytes."""
    rows = np.arange(3 * 24, dtype=np.uint8).reshape(3, 24)
    earlier, _ = native.rows_to_bytes(rows[::-1].copy(), np.array([24, 5, 24]))
    held = earlier[0]
    before = sys.getrefcount(held)
    spare = (earlier * 2)[:spares]
    del earlier
    got, _ = native.rows_to_bytes(rows, np.array([24, 0, 9]), spare)
    assert got == [bytes(range(24)), b"", bytes(range(48, 57))]
    assert spare == [] and held == bytes(range(48, 72))
    assert sys.getrefcount(held) == before - 1  # only this test holds it now


def test_the_decoder_keeps_its_last_large_outputs_for_the_next():
    """A trim from `NATIVE_TRIM_BYTES` keeps its outputs as the decoder's
    spares, and the next such trim lets them go as it makes its own; a
    caller that kept the earlier outputs still reads them unchanged.  A
    smaller trim leaves the spares as they are."""
    cfg = _config(16, 2)
    n = batch.NATIVE_TRIM_BYTES // (4 * F) + 2
    zero = torch.zeros(n, dtype=torch.int32)
    ns = torch.full((n,), F, dtype=torch.int32)
    dec = TorchBatchDecoder(cfg, "cpu")
    first_rows, second_rows = _rows(16, 2, n, seed=1), _rows(16, 2, n, seed=2)
    first = dec.finish_async((first_rows, zero, ns, zero.bool()), [b""] * n)
    assert len(dec._spare) == n and all(a is b for a, b in zip(dec._spare, first))
    kept = first[:3]
    del first
    second = dec.finish_async((second_rows, zero, ns, zero.bool()), [b""] * n)
    assert all(a is b for a, b in zip(dec._spare, second))
    assert second == [_slice(second_rows[k].numpy(), F, 16, 2) for k in range(n)]
    assert kept == [_slice(first_rows[k].numpy(), F, 16, 2) for k in range(3)]
    dec.finish_async((first_rows[:2], zero[:2], ns[:2], zero[:2].bool()), [b""] * 2)
    assert all(a is b for a, b in zip(dec._spare, second))
