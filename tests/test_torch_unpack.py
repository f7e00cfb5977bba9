"""Port wire-format unpack vs gnsstpu.ops.unpack: bit-exact, every format,
device path and host path, on the same packed bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnsstpu.ops import unpack as jup
from gnsstpu_torch.ops import unpack as tup
from gnsstpu_torch.runtime.sources import PackedArraySource
from torch_port import one_torch_thread_per_worker  # noqa: F401


@pytest.mark.parametrize("fmt", ["iq8", "iq4", "sm2", "iq1"])
def test_unpack_bit_exact(fmt):
    rng = np.random.default_rng(7)
    iq = rng.normal(0, 3.0, (4096, 2)).astype(np.float32)
    packed = jup.pack(iq, fmt, scale=1.0)
    want = np.asarray(jup.unpack(jnp.asarray(packed), fmt))
    got = tup.unpack(torch.from_numpy(packed), fmt).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tup.unpack_np(packed, fmt), want)
    # Every byte value decodes like the reference.
    allb = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        tup.unpack_np(allb, fmt), np.asarray(jup.unpack(jnp.asarray(allb),
                                                        fmt)))


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
