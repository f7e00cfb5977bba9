"""Port wire-format unpack vs gnsstpu.ops.unpack: bit-exact, every format,
device path and host path, on the same packed bytes.

The port decodes through one 256-row table per format and device
(ops/unpack.py table); these tests hold it to the reference's arithmetic
on every byte value and on one L3OC superepoch chunk of random bytes
(12,000,000 bytes). The reference is imported inside the tests that use
it, so the card test runs on a host without jax:
    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_unpack.py
"""

import numpy as np
import pytest
import torch

from gnsstpu_torch.ops import unpack as tup
from gnsstpu_torch.runtime.sources import PackedArraySource
from torch_port import one_torch_thread_per_worker  # noqa: F401

FORMATS = ["iq8", "iq4", "sm2", "iq1"]
#: One 1 s superepoch of the L3OC cell's sm2 feed (24 Msps, 2 pairs a
#: byte).
CHUNK_BYTES = 12_000_000
#: Reference slices of the chunk (the decode is a function of each byte,
#: so slicing at byte boundaries changes nothing; it bounds the memory).
SLICE_BYTES = 1_000_000


def _ref_unpack(packed: np.ndarray, fmt: str) -> np.ndarray:
    """gnsstpu.ops.unpack.unpack on the CPU, as NumPy."""
    import jax.numpy as jnp
    from gnsstpu.ops import unpack as jup

    return np.asarray(jup.unpack(jnp.asarray(packed), fmt))


def _chunk(seed: int = 24) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, CHUNK_BYTES,
                                                dtype=np.uint8)


def _assert_chunk_equals_reference(got: np.ndarray, packed: np.ndarray,
                                   fmt: str) -> None:
    per = int(2 * tup.samples_per_byte(fmt))      # f32 values a byte
    assert got.shape == (len(packed) * per // 2, 2)
    flat = got.reshape(-1)
    for b0 in range(0, len(packed), SLICE_BYTES):
        b1 = min(b0 + SLICE_BYTES, len(packed))
        want = _ref_unpack(packed[b0:b1], fmt).reshape(-1)
        np.testing.assert_array_equal(flat[b0 * per: b1 * per], want)


@pytest.mark.parametrize("fmt", FORMATS)
def test_unpack_bit_exact(fmt):
    from gnsstpu.ops import unpack as jup

    rng = np.random.default_rng(7)
    iq = rng.normal(0, 3.0, (4096, 2)).astype(np.float32)
    packed = jup.pack(iq, fmt, scale=1.0)
    want = _ref_unpack(packed, fmt)
    got = tup.unpack(torch.from_numpy(packed), fmt).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tup.unpack_np(packed, fmt), want)
    # Every byte value decodes like the reference.
    allb = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(tup.unpack_np(allb, fmt),
                                  _ref_unpack(allb, fmt))
    np.testing.assert_array_equal(
        tup.unpack(torch.from_numpy(allb), fmt).numpy(),
        _ref_unpack(allb, fmt))
    # One L3OC superepoch chunk of random bytes, through both paths.
    chunk = _chunk()
    got = tup.unpack(torch.from_numpy(chunk), fmt)
    assert got.dtype == torch.float32 and got.is_contiguous()
    _assert_chunk_equals_reference(got.numpy(), chunk, fmt)
    del got
    host = tup.unpack_np(chunk, fmt)
    assert host.dtype == np.float32 and host.flags.c_contiguous
    _assert_chunk_equals_reference(host, chunk, fmt)


@pytest.mark.parametrize("fmt", FORMATS)
def test_table_built_once_per_format_and_device(fmt, monkeypatch):
    """The table is the reference arithmetic run once over every byte
    value: f32 [256, 2 x samples a byte]; unpack and unpack_np reuse it,
    and the decode is a contiguous f32 [N, 2]. CPU decodes are not card
    decodes."""
    monkeypatch.setattr(tup, "_TABLES", {})
    built = []
    arith = tup._decode_arith

    def counted(p, f):
        built.append(f)
        return arith(p, f)

    monkeypatch.setattr(tup, "_decode_arith", counted)
    before = dict(tup.DECODES)
    packed = np.arange(256, dtype=np.uint8).repeat(4)
    a = tup.unpack(torch.from_numpy(packed), fmt)
    lut = tup.table(fmt, "cpu")
    b = tup.unpack_np(packed, fmt)
    c = tup.unpack(torch.from_numpy(packed[::-1].copy()), fmt)
    assert built == [fmt]
    assert tup.table(fmt, torch.device("cpu")) is lut
    assert list(tup._TABLES) == [(fmt, torch.device("cpu"))]
    per = int(2 * tup.samples_per_byte(fmt))
    assert lut.dtype == torch.float32 and lut.shape == (256, per)
    np.testing.assert_array_equal(lut.numpy().reshape(-1, 2),
                                  arith(torch.arange(256, dtype=torch.int32),
                                        fmt).numpy())
    for out in (a, c):
        assert out.dtype == torch.float32 and out.is_contiguous()
        assert out.shape == (len(packed) * per // 2, 2)
    assert b.dtype == np.float32 and b.shape == tuple(a.shape)
    np.testing.assert_array_equal(b, a.numpy())
    assert tup.DECODES == before


def test_unknown_format_raises():
    with pytest.raises(ValueError, match="unknown wire format"):
        tup.unpack(torch.zeros(4, dtype=torch.uint8), "iq3")


def test_packed_source_read_matches_reference():
    from gnsstpu.runtime.sources import PackedArraySource as JPacked

    rng = np.random.default_rng(8)
    iq = rng.normal(0, 1.0, (10000, 2)).astype(np.float32)
    a, b = JPacked(iq, fmt="sm2"), PackedArraySource(iq, fmt="sm2")
    assert len(a) == len(b)
    for start, count in ((0, 100), (37, 501), (-9, 40), (9990, 30)):
        np.testing.assert_array_equal(b.read(start, count),
                                      a.read(start, count))
    np.testing.assert_array_equal(b.read_packed(64, 256),
                                  a.read_packed(64, 256))


# --- on the card -----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_card_decode_equals_cpu(fmt):
    """The card's table decode of one L3OC superepoch chunk equals the
    CPU's bit for bit; one card decode counted, one table per (format,
    card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with pytest "
                    "--noconftest -m cuda tests/test_torch_unpack.py")
    card = torch.device("cuda", 0)
    chunk = _chunk()
    before = tup.DECODES["unpack"]
    got = tup.unpack(torch.from_numpy(chunk).to(card), fmt)
    assert tup.DECODES["unpack"] == before + 1
    assert got.device == card and got.dtype == torch.float32
    assert got.is_contiguous()
    want = tup.unpack_np(chunk, fmt)
    assert torch.equal(got.cpu().view(torch.int32),
                       torch.from_numpy(want).view(torch.int32))
    assert tup.table(fmt, card) is tup.table(fmt, got.device)
