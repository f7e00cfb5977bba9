"""Port FDMA acquisition and the port ChannelManager on GLONASS L1OF vs
gnsstpu's, on the CPU.

  * acquire_fdma on tests/test_glonass.py's two-satellite L1OF (8.192
    Msps) and L2OF signals, one reference search each: the same
    detections and code phases, the peak metric to rtol 1e-4, carr_freq
    (IF + channel offset + Doppler) to 1e-3 Hz with fine Doppler off and
    0.05 Hz with it on;
  * acquire() on an FDMA signal refuses, naming acquire_fdma (a deviation:
    the reference would search a per-PRN grid that finds no channel but
    the zero one);
  * both managers on tests/test_pipeline.py's FDMA reacquisition setup
    (4.096 Msps, frequency channels 5 and 12, 12 appearing at 400 ms)
    with the exact scan engine ('gather', 4-epoch serial superepochs,
    1.2 s):
    the same channel_start events, the same slot PRNs and states at every
    epoch, one host-path search (the cold start), and prompts / Doppler /
    sample positions to 1e-4 of their scale (test_torch_manager.py's
    tolerances); with the fused engines (port: K1's twin; reference: the
    Pallas kernel in interpret mode) over 800 ms in one-epoch
    superepochs, prompts within rtol 2e-3 atol 2 and Doppler within
    0.05 Hz. (In a longer serial superepoch channel 5's cursor drifts to
    sample -1, before its window: the Pallas kernel's read there is
    undefined, K1 and its twin read zeros.)
"""

import functools
import io
import json

import numpy as np
import pytest

from gnsstpu.acquisition import search as jsearch
from gnsstpu.acquisition.search import acq_samples_needed
from gnsstpu.config import AcqConfig, ReceiverConfig, SignalConfig, TrackConfig
from gnsstpu.ops import fft_acquire as jfft
from gnsstpu.runtime.manager import ChannelManager as JManager
from gnsstpu.runtime.sources import ArraySource as JArray
from gnsstpu.runtime.telemetry import Telemetry
from gnsstpu.signals import glonass as sgl
from gnsstpu.sim import IFSimulator, SatParams
from gnsstpu_torch.acquisition import search as tsearch
from gnsstpu_torch.runtime.manager import ChannelManager as TManager
from gnsstpu_torch.runtime.sources import ArraySource as TArray
from gnsstpu_torch.runtime.telemetry import Telemetry as TTelemetry
from test_pipeline import LateSvSource
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import to_port

L1 = SignalConfig(signal="glonass_l1of", if_freq=0.0, fs=8.192e6,
                  code_freq=0.511e6, code_length=511, fdma_step=562.5e3)
L2 = SignalConfig(signal="glonass_l2of", if_freq=0.0, fs=8.192e6,
                  code_freq=0.511e6, code_length=511,
                  fdma_step=sgl.L2_STEP_HZ, complex_iq=True)
#: tests/test_glonass.py's two-satellite skies and seeds, by signal.
SKIES = {
    "l1of": (L1, 9, [(5, 1100.0, -3 * 562.5e3, 123.4),
                     (12, -2400.0, 4 * 562.5e3, 402.8)]),
    "l2of": (L2, 11, [(5, 900.0, -3 * sgl.L2_STEP_HZ, 88.2),
                      (12, -1700.0, 4 * sgl.L2_STEP_HZ, 311.7)]),
}


@pytest.fixture(scope="module", params=sorted(SKIES))
def fdma_search(request):
    """(band, samples, reference result with 10 ms fine Doppler, its
    coarse carr_freq): one reference search gives both settings, the
    coarse values being what its refine_doppler calls were handed. The
    reference's transform takes the one code row alone (prn_chunk=1), not
    padded to its default 8-row chunk: the same cube in an eighth of the
    work."""
    sig, seed, sky = SKIES[request.param]
    sats = [SatParams(prn=p, doppler_hz=fd, if_offset_hz=off,
                      code_phase_chips=cp, cn0_dbhz=48.0)
            for p, fd, off, cp in sky]
    acq = AcqConfig(doppler_band=8e3, coherent_ms=2, threshold=2.5,
                    fine_doppler_ms=10)
    n = acq_samples_needed(sig, acq)
    x = np.asarray(IFSimulator(sig, sats, noise_sigma=1.0,
                               seed=seed).generate(n // 8192 + 1))[:n]
    coarse = {}
    refine = jsearch.refine_doppler

    def recording_refine(samples, sig_, prn, code_phase, carr, **kw):
        coarse[prn] = carr
        return refine(samples, sig_, prn, code_phase, carr, **kw)

    cube = jfft.acquire_cube
    jsearch.refine_doppler = recording_refine
    jfft.acquire_cube = functools.partial(cube, prn_chunk=1)
    try:
        ref = jsearch.acquire_fdma(x, sig, acq)
    finally:
        jsearch.refine_doppler = refine
        jfft.acquire_cube = cube
    carr0 = ref.carr_freq.copy()
    for prn, c in coarse.items():
        carr0[prn - 1] = c
    return request.param, x, ref, carr0


@pytest.mark.parametrize("fine", [0, 10])
def test_acquire_fdma_matches_reference(fdma_search, fine):
    band, x, ref, carr0 = fdma_search
    sig, _, sky = SKIES[band]
    acq = AcqConfig(doppler_band=8e3, coherent_ms=2, threshold=2.5,
                    fine_doppler_ms=fine)
    got = tsearch.acquire_fdma(x, to_port(sig), to_port(acq), device="cpu")
    assert got.detected_prns() == ref.detected_prns() == [5, 12]
    np.testing.assert_array_equal(got.detected, ref.detected)
    np.testing.assert_array_equal(got.code_phase, ref.code_phase)
    np.testing.assert_allclose(got.peak_metric, ref.peak_metric, rtol=1e-4)
    np.testing.assert_allclose(got.carr_freq,
                               ref.carr_freq if fine else carr0, rtol=0,
                               atol=0.05 if fine else 1e-3)
    for p, fd, off, _ in sky:
        assert abs(got.carr_freq[p - 1] - (off + fd)) <= 200.0


def test_acquire_refuses_fdma():
    x = np.zeros((8 * 8192, 2), np.float32)
    with pytest.raises(ValueError, match="acquire_fdma"):
        tsearch.acquire(x, to_port(L1), to_port(AcqConfig(coherent_ms=1)),
                        device="cpu")


MSIG = SignalConfig(signal="glonass_l1of", if_freq=0.0, fs=4.096e6,
                    code_freq=0.511e6, code_length=511,
                    fdma_step=562.5e3, complex_iq=True)


@pytest.fixture(scope="module")
def late_samples():
    """tests/test_pipeline.py::test_fdma_chunk_reacquisition's signal:
    channel 12 appears at 400 ms."""
    step = 562.5e3
    sats = [SatParams(prn=5, doppler_hz=1100.0, if_offset_hz=-3 * step,
                      code_phase_chips=120.5, cn0_dbhz=47.0),
            SatParams(prn=12, doppler_hz=-1700.0, if_offset_hz=4 * step,
                      code_phase_chips=333.25, cn0_dbhz=46.0)]
    src = LateSvSource(MSIG, sats, 1700, switch_ms=400)
    return src.read(0, len(src))


def _cfg():
    return ReceiverConfig(
        signal=MSIG,
        acq=AcqConfig(doppler_band=4e3, coherent_ms=2, threshold=2.2,
                      prn_list=(5, 12), fine_doppler_ms=10),
        track=TrackConfig(dll_bw=1.0), n_channels=3)


def run_both(cfg, samples, n_ms, **kw):
    """The reference's and the port's manager on the same samples and
    config (the port on the CPU); returns [(manager, telemetry lines)]
    for (reference, port)."""
    out = []
    for cls, src, tlm_cls, c, extra in (
            (JManager, JArray, Telemetry, cfg, {}),
            (TManager, TArray, TTelemetry, to_port(cfg),
             {"device": "cpu"})):
        sink = io.StringIO()
        mgr = cls(src(samples.copy()), c, telemetry=tlm_cls(sink=sink),
                  **kw, **extra)
        mgr.run(n_ms)
        out.append((mgr, [json.loads(ln)
                          for ln in sink.getvalue().splitlines()]))
    return out


def starts(lines):
    return [(e["prn"], e["epoch_ms"], e["code_phase"], e["doppler_hz"])
            for e in lines if e.get("what") == "channel_start"]


def slot_states(lines):
    """(epoch_ms, slot, prn, state) of every channel_health record."""
    return [(e["epoch_ms"], e["chan"], e["prn"], e["state"])
            for e in lines if e.get("type") == "channel_health"]


def host_searches(lines):
    return [e["epoch_ms"] for e in lines if e.get("stage") == "acquire"]


def test_fdma_manager_gather_matches_reference(late_samples):
    (jm, jl), (tm, tl) = run_both(
        _cfg(), late_samples, 1200, epoch_ms=100, reacq_period_ms=300,
        cn0_drop_dbhz=35.0, prn_pool=[5, 12], sync_every=4,
        engine="gather")
    assert starts(tl) == starts(jl)
    assert [(p, ms) for p, ms, _, _ in starts(tl)] == [(5, 0), (12, 800)]
    assert slot_states(tl) == slot_states(jl)
    assert host_searches(tl) == host_searches(jl) == [0]
    for a, b in zip(tm.records, jm.records):
        assert a.epoch_ms == b.epoch_ms
        np.testing.assert_array_equal(a.prn, b.prn)
        np.testing.assert_allclose(a.cn0_dbhz, b.cn0_dbhz, atol=1e-2)
    assert len(tm.records) == len(jm.records) == 12
    live = {s.prn for s in tm.slots if s.state.value == "tracking"}
    assert live == {5, 12}
    for prn in (5, 12):
        h, g = tm.prompt_stream(prn), jm.prompt_stream(prn)
        for lane in ("i_p", "q_p", "carr_doppler", "abs_sample"):
            scale = float(np.max(np.abs(g[lane])))
            np.testing.assert_allclose(h[lane], g[lane], rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=lane)
    i12 = list(tm.records[-1].prn).index(12)
    assert abs(tm.records[-1].doppler_hz[i12] + 1700.0) < 8.0


def test_fdma_manager_fused_matches_reference(late_samples):
    (jm, jl), (tm, tl) = run_both(
        _cfg(), late_samples, 800, epoch_ms=100, reacq_period_ms=300,
        cn0_drop_dbhz=35.0, prn_pool=[5, 12], sync_every=1,
        engine="fused")
    assert tm.engine == jm.engine == "fused"
    assert starts(tl) == starts(jl)
    assert [(p, ms) for p, ms, _, _ in starts(tl)] == [(5, 0), (12, 700)]
    assert slot_states(tl) == slot_states(jl)
    assert host_searches(tl) == host_searches(jl) == [0]
    for prn in (5, 12):
        h, g = tm.prompt_stream(prn), jm.prompt_stream(prn)
        for lane in ("i_p", "q_p"):
            np.testing.assert_allclose(h[lane], g[lane], rtol=2e-3,
                                       atol=2.0, err_msg=lane)
        np.testing.assert_allclose(h["carr_doppler"], g["carr_doppler"],
                                   rtol=0, atol=0.05)
