"""Port NCO ops vs gnsstpu.ops.nco: integer phases and LO angles must be
bit-exact (same u32 wrap, same f32 conversion and scale); the cos/sin of
those angles may differ in the last ulp between XLA's and PyTorch's CPU
math libraries, hence 2e-7 on the LO planes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnsstpu.ops import nco as jnco
from gnsstpu_torch.device import u32_numpy, u32_tensor
from gnsstpu_torch.ops import nco as tnco
from torch_port import one_torch_thread_per_worker  # noqa: F401

CPU = torch.device("cpu")


def _rand_u32(rng, n):
    return rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(
        np.uint32)


def test_freq_to_step_u32_matches():
    for f in (0.0, 1250.5, -4200.25, 2.42e6, 4.092e6 + 0.37):
        assert tnco.freq_to_step_u32(f, 2.048e6) == \
            jnco.freq_to_step_u32(f, 2.048e6)


def test_delta_step_and_ramp_exact():
    rng = np.random.default_rng(0)
    d = rng.uniform(-8e3, 8e3, 64).astype(np.float32)
    want = np.asarray(jnco.delta_freq_to_step_i32(jnp.asarray(d), 2.048e6))
    got = tnco.delta_freq_to_step_i32(torch.from_numpy(d), 2.048e6)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))

    ph, st = _rand_u32(rng, 1)[0], _rand_u32(rng, 1)[0]
    jp, jf = jnco.carrier_ramp_u32(jnp.uint32(ph), jnp.uint32(st), 2050)
    tp, tf = tnco.carrier_ramp_u32(u32_tensor(ph, CPU),
                                   u32_tensor(st, CPU), 2050)
    np.testing.assert_array_equal(u32_numpy(tp), np.asarray(jp))
    assert int(u32_numpy(tf)) == int(jf)


def test_phase_angles_bit_exact():
    rng = np.random.default_rng(1)
    ph = _rand_u32(rng, 4096)
    want = np.asarray(jnco.phase_u32_to_angle(jnp.asarray(ph)))
    got = tnco.phase_u32_to_angle(u32_tensor(ph, CPU)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2050, 1023, 64])
def test_factored_lo_angles_bit_exact(n):
    """Coarse/fine angles of the k = 64a + r factorization equal the
    reference's (lo_iq_factored's ka/kr angles), and the combined LO
    planes agree with the reference's to f32 rounding."""
    rng = np.random.default_rng(n)
    for ph, st in zip(_rand_u32(rng, 4), _rand_u32(rng, 4)):
        a_n = -(-n // 64)
        ka = jnp.uint32(ph) + jnp.arange(a_n, dtype=jnp.uint32) * (
            jnp.uint32(64) * jnp.uint32(st))
        kr = jnp.arange(64, dtype=jnp.uint32) * jnp.uint32(st)
        aa, ar = tnco.lo_angles_factored(u32_tensor(ph, CPU),
                                         u32_tensor(st, CPU), n)
        np.testing.assert_array_equal(
            aa.numpy(), np.asarray(jnco.phase_u32_to_angle(ka)))
        np.testing.assert_array_equal(
            ar.numpy(), np.asarray(jnco.phase_u32_to_angle(kr)))
        jc, js = jnco.lo_iq_factored(jnp.uint32(ph), jnp.uint32(st), n)
        tc, ts = tnco.lo_iq_factored(u32_tensor(ph, CPU),
                                     u32_tensor(st, CPU), n)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                                   atol=2e-7)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                                   atol=2e-7)
