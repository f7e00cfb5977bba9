"""Port FFT acquisition (torch.fft, complex64) vs gnsstpu's Stockham path.

Same samples (JAX IFSimulator on the CPU): the power cube agrees to
rtol 1e-3 of its peak (two different f32 FFT algorithms), and the search
picks the same PRNs, code phases and Doppler bins. The port's pilot +
data search is gated to GLONASS L3OC: a single-code signal's cube is
left as it is. The live manager's on-chunk search for a few PRNs
correlates only their code rows and reads what the whole bank reads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnsstpu.acquisition import search as jsearch
from gnsstpu.config import AcqConfig, SignalConfig
from gnsstpu.ops import fft_acquire as jfft
from gnsstpu.sim import IFSimulator, SatParams
from gnsstpu_torch import config as tconfig
from gnsstpu_torch import sim as tsim
from gnsstpu_torch.acquisition import search as tsearch
from gnsstpu_torch.ops import fft_acquire as tfft
from gnsstpu_torch.runtime.manager import ChannelManager
from gnsstpu_torch.runtime.sources import ArraySource
from gnsstpu_torch.runtime.telemetry import Telemetry
from gnsstpu_torch.signals import glonass_l3
from gnsstpu_torch.signals.registry import get_signal
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


@pytest.mark.parametrize("signal,combines", [("gps_l1ca", False),
                                             ("beidou_b1i", False),
                                             ("galileo_e1b", False),
                                             ("glonass_l3oc", True)])
def test_only_pilot_and_data_signals_combine(signal, combines):
    """The gate of the pilot + data search (a deviation from the
    reference): on GLONASS L3OC, whose satellites send code prn + 32
    beside the pilot code prn, each data code's power is added into its
    pilot code's row at every (Doppler, lag) cell and the data rows stay;
    on a single-code signal the cube is left bit for bit as it was."""
    P = get_signal(signal).num_prn
    cube = torch.rand((P, 3, 16), generator=torch.Generator().manual_seed(3))
    before = cube.clone()
    assert tsearch.combine_components(cube, signal) is combines
    off = tsearch.data_code_offset(signal)
    if not combines:
        assert off is None and torch.equal(cube, before)
        return
    assert off == 32 and P == 63
    assert torch.equal(cube[:P - off], before[:P - off] + before[off:])
    assert torch.equal(cube[P - off:], before[P - off:])


def test_single_code_search_does_not_combine():
    """A GPS search through acquire: the cube is not combined, and the
    result says so and counts the whole code bank."""
    acq = AcqConfig(doppler_band=6e3, coherent_ms=2, threshold=2.4)
    got = tsearch.acquire(_samples(), to_port(SIG), to_port(acq),
                          device="cpu")
    assert not got.combined and got.codes == get_signal("gps_l1ca").num_prn
    assert got.detected_prns() == [3, 17]


def test_code_spectra_are_made_once_and_shared():
    """code_fd_tensor builds a signal's conj code spectra once a process
    for each front end, coherent length and device, and hands every
    caller that tensor: the reference's table, bit for bit."""
    acq = to_port(AcqConfig(doppler_band=4e3, coherent_ms=2))
    a = tsearch.code_fd_tensor(to_port(SIG), acq, "cpu")
    assert tsearch.code_fd_tensor(to_port(SIG), acq, torch.device("cpu")) \
        is a
    fd_re, fd_im = jfft.code_fd_table(SIG.signal, SIG.fs, SIG.code_freq,
                                      SIG.code_length, 2)
    np.testing.assert_array_equal(a.real.numpy(), fd_re)
    np.testing.assert_array_equal(a.imag.numpy(), fd_im)
    other = tsearch.code_fd_tensor(
        to_port(SIG), to_port(AcqConfig(coherent_ms=1)), "cpu")
    assert other is not a and other.shape[1] == a.shape[1] // 2


L3SIG = tconfig.SignalConfig(signal="glonass_l3oc", if_freq=0.0, fs=12.0e6,
                             code_freq=glonass_l3.CODE_FREQ,
                             code_length=glonass_l3.CODE_LENGTH,
                             complex_iq=True)


def _l3_sats():
    """Satellites 8 and 20, each its pilot code and, in quadrature at
    equal power, its data code."""
    sats = []
    for prn, fd, cp in ((8, -1750.0, 4100.25), (20, 1320.0, 2345.5)):
        for code, ph in ((glonass_l3.pilot_prn(prn), 0.0),
                         (glonass_l3.data_prn(prn), np.pi / 2)):
            sats.append(tsim.SatParams(prn=code, doppler_hz=fd,
                                       code_phase_chips=cp, cn0_dbhz=47.0,
                                       carrier_phase=ph))
    return sats


@pytest.mark.parametrize("signal,want,codes", [
    ("gps_l1ca", [3], 1),
    ("gps_l1ca", [3, 9, 17, 30], 4),
    ("glonass_l3oc", [20], 2),            # pilot 20 + data 52
    ("glonass_l3oc", [32], 1),            # no data code beside 32
    ("glonass_l3oc", [8, 20, 31, 32, 40], 8),  # 40: also 8's data code
])
def test_chunk_search_for_wanted_prns_reads_the_whole_bank(signal, want,
                                                          codes):
    """The manager's on-chunk search run for `want` correlates only the
    code rows of those PRNs (pilot rows, and on L3OC the data rows summed
    into them), and reads for each of them the metric, code phase and
    Doppler bin that the search of the whole bank reads (bit for bit on
    the CPU); every other PRN's lanes read 0."""
    if signal == "gps_l1ca":
        sig = to_port(SIG)
        sats = [tsim.SatParams(prn=s.prn, doppler_hz=s.doppler_hz,
                               code_phase_chips=s.code_phase_chips,
                               cn0_dbhz=s.cn0_dbhz) for s in SATS]
        acq = tconfig.AcqConfig(doppler_band=6e3, coherent_ms=2,
                                threshold=2.4)
    else:
        sig, sats = L3SIG, _l3_sats()
        acq = tconfig.AcqConfig(doppler_band=4e3, coherent_ms=1,
                                threshold=2.5, doppler_step=250.0)
    x = tsim.IFSimulator(sig, sats, noise_sigma=1.0, seed=5,
                         device="cpu").generate(6)
    P = get_signal(signal).num_prn
    tlm = Telemetry(trace=True)
    mgr = ChannelManager(
        ArraySource(x), tconfig.ReceiverConfig(signal=sig, acq=acq,
                                               n_channels=2),
        device="cpu", epoch_ms=2, telemetry=tlm)
    search = mgr._make_acq_chunk_fn()
    chunk = torch.as_tensor(np.asarray(x, np.float32))
    with tlm.span("acq.chunk_search"):
        whole = search(chunk, list(range(1, P + 1))).numpy()
    with tlm.span("acq.chunk_search"):
        got = search(chunk, want).numpy()
    assert [s["counters"]["codes"] for s in tlm.spans
            if s["name"] == "acq.chunk_search"] == [P, codes]
    rows = [p - 1 for p in want]
    np.testing.assert_array_equal(got[:, rows], whole[:, rows])
    rest = np.setdiff1d(np.arange(P), rows)
    assert not got[:, rest].any()
    assert (got[0, rows] > acq.threshold).tolist() == [
        p in (3, 17, 8, 20) for p in want]
