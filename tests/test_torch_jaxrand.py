"""The port's JAX-compatible random numbers (sim/jaxrand.py) and
IFSimulator(noise="jax") vs jax.random and gnsstpu's simulator, on the
CPU.

Keys, bits and uniforms equal JAX's exactly; normals within 3e-5 (the two
libraries' float32 erfinv differ in the last bits). The simulator's
samples then equal the reference's to 1e-4, but where a sample sits on a
code chip's edge and float32 rounds its chip index the other way (a jump
of twice the amplitude; under 1e-4 of the samples); the reference
test's SimSource reads come out the same. That is how chip_smoke.py
tracks the reference tests' own signals on the card.
"""

import jax
import numpy as np
import pytest

from gnsstpu.config import SignalConfig
from gnsstpu.runtime.sources import SimSource as JSimSource
from gnsstpu.sim import IFSimulator as JSim
from gnsstpu.sim import SatParams as JSat
from gnsstpu_torch.runtime.sources import SimSource
from gnsstpu_torch.sim import IFSimulator, SatParams
from gnsstpu_torch.sim import jaxrand
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import to_port

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
SATS = ((3, 1200.0, 100.5), (17, -700.0, 800.25), (25, 2900.0, 411.75))


@pytest.mark.parametrize("seed,data", [(0, 0), (21, 7), (23, 512),
                                       (2 ** 31 - 1, 2 ** 32 - 1)])
def test_keys_match(seed, data):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    assert jaxrand.prng_key(seed) == tuple(
        int(v) for v in np.asarray(jax.random.key_data(
            jax.random.PRNGKey(seed))))
    assert jaxrand.fold_in(jaxrand.prng_key(seed), data) == tuple(
        int(v) for v in np.asarray(jax.random.key_data(jkey)))


def test_bits_uniform_normal_match():
    key = jaxrand.fold_in(jaxrand.prng_key(23), 5)
    jkey = jax.random.fold_in(jax.random.PRNGKey(23), 5)
    shape = (37, 1011)
    np.testing.assert_array_equal(
        jaxrand.random_bits(key, shape, "cpu").numpy().astype(np.uint32),
        np.asarray(jax.random.bits(jkey, shape)))
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    np.testing.assert_array_equal(
        jaxrand.uniform(key, shape, lo, 1.0, "cpu").numpy(),
        np.asarray(jax.random.uniform(jkey, shape, minval=lo, maxval=1.0)))
    got = jaxrand.normal(key, shape, "cpu").numpy()
    ref = np.asarray(jax.random.normal(jkey, shape))
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-5)
    assert abs(got.std() - 1.0) < 0.01


def _sims(noise_sigma=1.0, seed=21):
    jsim = JSim(SIG, [JSat(prn=p, doppler_hz=d, code_phase_chips=c,
                           cn0_dbhz=47.0) for p, d, c in SATS],
                noise_sigma=noise_sigma, seed=seed)
    tsim = IFSimulator(to_port(SIG), [SatParams(
        prn=p, doppler_hz=d, code_phase_chips=c, cn0_dbhz=47.0)
        for p, d, c in SATS], noise_sigma=noise_sigma, seed=seed,
        device="cpu", noise="jax")
    return jsim, tsim


def _close_but_code_edges(got, ref, amp_max):
    """Samples within 1e-4 but for chip-edge flips (under 1e-4 of them,
    each under twice the largest amplitude plus 1e-4)."""
    d = np.abs(got - ref)
    edge = d > 1e-4
    assert edge.mean() < 1e-4, edge.sum()
    assert np.all(d[edge] < 2.0 * amp_max + 1e-4)


def test_simulator_makes_the_reference_signal():
    jsim, tsim = _sims()
    amp = float(np.max(tsim._amps))
    for ms0, n in ((0, 40), (513, 25)):
        _close_but_code_edges(tsim.generate(n, ms0), jsim.generate(n, ms0),
                              amp)
    with pytest.raises(ValueError, match="noise"):
        IFSimulator(to_port(SIG), [SatParams(prn=1)], device="cpu",
                    noise="numpy")


def test_simsource_reads_match_the_reference():
    """The reference test's source: lazily made pieces keyed by their
    first ms; the same reads give the same samples."""
    jsim, tsim = _sims(seed=23)
    js, ts = JSimSource(jsim, 700), SimSource(tsim, 700)
    amp = float(np.max(tsim._amps))
    for start, count in ((0, 6000), (1500, 1_060_000), (1_030_000, 400_000)):
        _close_but_code_edges(ts.read(start, count), js.read(start, count),
                              amp)
