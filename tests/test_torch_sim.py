"""Port IF simulator and GPS scenario vs gnsstpu.sim.

With noise_sigma=0 both synthesize the same noise-free signal from the
same f64 host bookkeeping and f32 device ramps: agree to 1e-4. The noise
comes from a torch.Generator (not jax.random), so with noise only its
statistics are checked.
"""

import numpy as np
import torch

from gnsstpu.config import SignalConfig
from gnsstpu.nav.types import Ephemeris
from gnsstpu.sim import IFSimulator as JSim
from gnsstpu.sim import SatParams as JSat
from gnsstpu.sim.scenario import build_scenario as j_build
from gnsstpu_torch.sim import IFSimulator, SatParams
from gnsstpu_torch.sim import scenario as tscen
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import to_port

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)


def _sats(cls):
    bits = np.where(np.arange(7) % 3 == 0, -1.0, 1.0)
    return [cls(prn=5, doppler_hz=900.0, doppler_rate=-0.7,
                code_phase_chips=200.5, cn0_dbhz=47.0, nav_bits=bits),
            cls(prn=12, doppler_hz=-1500.0, code_phase_chips=700.25,
                carrier_phase=1.1, cn0_dbhz=46.0)]


def test_noise_free_signal_matches_reference():
    ref = JSim(SIG, _sats(JSat), noise_sigma=0.0, seed=1).generate(45, 3)
    got = IFSimulator(to_port(SIG), _sats(SatParams), noise_sigma=0.0,
                      seed=1, device="cpu").generate(45, 3)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-4)


def test_noise_statistics_and_seeding():
    sim = IFSimulator(to_port(SIG), _sats(SatParams)[:1], noise_sigma=1.0,
                      seed=9, device="cpu")
    a, b = sim.generate(20), sim.generate(20)
    np.testing.assert_array_equal(a, b)              # seeded by (seed, ms0)
    assert not np.array_equal(a, sim.generate(20, ms0=20))
    var = a.var(axis=0)
    np.testing.assert_allclose(var, 0.5, rtol=0.05)
    assert isinstance(sim.generate_tensor(2), torch.Tensor)


def test_build_scenario_matches_reference():
    eph = Ephemeris(
        t_oc=266400.0, a_f0=2.45e-4, a_f1=-3.2e-12, a_f2=0.0,
        T_GD=-4.656e-9, sqrtA=5153.712, e=0.0123456, M_0=1.23456,
        deltan=4.2e-9, omega=-1.87654, omega_0=-2.0312, omegaDot=-8.1e-9,
        i_0=0.96123, iDot=4.0e-10, t_oe=266400.0, C_uc=-6.7e-7,
        C_us=8.1e-6, C_rc=221.5625, C_rs=-12.8125, C_ic=-7.45e-8,
        C_is=1.12e-7, valid=True)
    recv = tscen.BENCH_RECV_ECEF
    a = j_build(SIG, {7: eph}, recv, 44400, duration_s=8.0, n_subframes=2)
    b = tscen.build_scenario(to_port(SIG), {7: to_port(eph)}, recv, 44400,
                             duration_s=8.0, n_subframes=2)
    for sa, sb in zip(a, b):
        for f in ("prn", "doppler_hz", "doppler_rate", "code_phase_chips",
                  "carrier_phase", "cn0_dbhz"):
            assert getattr(sa, f) == getattr(sb, f)
        np.testing.assert_array_equal(sa.nav_bits, sb.nav_bits)
