"""Port FFT acquisition (torch.fft, complex64) vs gnsstpu's Stockham path.

Same samples (JAX IFSimulator on the CPU): the power cube agrees to
rtol 1e-3 of its peak (two different f32 FFT algorithms), and the search
picks the same PRNs, code phases and Doppler bins.
"""

import jax.numpy as jnp
import numpy as np
import torch

from gnsstpu.acquisition import search as jsearch
from gnsstpu.config import AcqConfig, SignalConfig
from gnsstpu.ops import fft_acquire as jfft
from gnsstpu.sim import IFSimulator, SatParams
from gnsstpu_torch.acquisition import search as tsearch
from gnsstpu_torch.ops import fft_acquire as tfft
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import to_port

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
SATS = [SatParams(prn=3, doppler_hz=1250.0, code_phase_chips=100.3,
                  cn0_dbhz=46.0),
        SatParams(prn=17, doppler_hz=-2750.0, code_phase_chips=611.0,
                  cn0_dbhz=45.0)]


def _samples(n_ms=12):
    return np.asarray(IFSimulator(SIG, SATS, noise_sigma=1.0,
                                  seed=11).generate(n_ms))


def test_cube_matches_stockham():
    acq = AcqConfig(doppler_band=4e3, coherent_ms=1)
    x = _samples()
    spc = SIG.samples_per_code
    blocks, combine = jsearch._stack_windows(x, spc, acq)
    fd_re, fd_im = jfft.code_fd_table(SIG.signal, SIG.fs, SIG.code_freq,
                                      SIG.code_length, 1)
    fd_re, fd_im = fd_re[[2, 16, 24]], fd_im[[2, 16, 24]]
    dopp = jfft.doppler_grid(0.0, acq.doppler_band, acq.doppler_bin_step())
    want = np.asarray(jfft.acquire_cube(
        blocks, jnp.asarray(fd_re), jnp.asarray(fd_im),
        jnp.asarray(dopp, jnp.float32), SIG.fs, spc, combine=combine,
        fft_mode="stockham"))
    fd = torch.complex(torch.from_numpy(fd_re), torch.from_numpy(fd_im))
    got = tfft.acquire_cube(
        torch.tensor(np.asarray(blocks)), fd,
        torch.tensor(dopp, dtype=torch.float32), SIG.fs, spc,
        combine=combine).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * float(want.max()))
    for name in ("metric", "code_phase", "doppler_bin"):
        a = tfft.peak_metrics(torch.from_numpy(got), samples_per_code=spc,
                              samples_per_chip=2)[name].numpy()
        b = np.asarray(jfft.peak_metrics(jnp.asarray(want),
                                         samples_per_code=spc,
                                         samples_per_chip=2)[name])
        if name == "metric":
            np.testing.assert_allclose(a, b, rtol=1e-3)
        else:
            np.testing.assert_array_equal(a, b)


def test_acquire_same_detections():
    acq = AcqConfig(doppler_band=6e3, coherent_ms=2, threshold=2.4,
                    fine_doppler_ms=5)
    x = _samples()
    ref = jsearch.acquire(x, SIG, acq)
    got = tsearch.acquire(x, to_port(SIG), to_port(acq), device="cpu")
    assert got.detected_prns() == ref.detected_prns() == [3, 17]
    for i in (2, 16):
        assert int(got.code_phase[i]) == int(ref.code_phase[i])
        assert abs(got.carr_freq[i] - ref.carr_freq[i]) < 1.0
    np.testing.assert_allclose(got.peak_metric, ref.peak_metric, rtol=1e-3)
    assert tsearch.acq_samples_needed(to_port(SIG), to_port(acq)) == \
        jsearch.acq_samples_needed(SIG, acq)
