"""Port weak-tier acquisition (a noncoherent search longer than one
superepoch chunk, summed on the device across chunks) vs gnsstpu's, on
the CPU, with the exact scan engine ('gather') on both managers:

  * tests/test_pipeline.py's CDMA weak tier (GPS 2.048 Msps, serial
    superepochs) and its FDMA mirror (GLONASS L1OF 4.096 Msps, the
    prefetch pipeline), a satellite appearing at 400 ms, each cut to
    20 ms superepochs and fewer noncoherent windows (10 ms x 3 and
    4 ms x 8, still two or three chunks per search), the FDMA one to a
    500 ms reacquisition period (one accumulation, from 500 ms), and
    each run to ~100 ms past the late satellite's start, so that both
    managers run in seconds: the same channel_start events, one
    host-path search (the cold start), and each finished accumulation's
    [3, P] peak lanes
    (metric, code phase, Doppler bin) with the metric to rtol 1e-4 and
    the rest equal. The reference's acquire_cube pads the FDMA search's
    one code row to an 8-row PRN chunk of its CPU transform; for the FDMA
    case the test hands it one-row chunks and its f32 matmul transform
    ('mm', the TPU's weak-search path): the same cube, in a quarter of
    the time;
  * test_pipeline.py's refusal of an advance shorter than one coherent
    window (summing it would count windows twice).
"""

import functools
import io
import json

import numpy as np
import pytest

from gnsstpu.config import AcqConfig, ReceiverConfig, SignalConfig, TrackConfig
from gnsstpu.ops import fft_acquire as jfft
from gnsstpu.runtime.manager import ChannelManager as JManager
from gnsstpu.runtime.sources import ArraySource as JArray
from gnsstpu.runtime.telemetry import Telemetry
from gnsstpu.sim import IFSimulator, SatParams
from gnsstpu_torch.runtime.manager import ChannelManager as TManager
from gnsstpu_torch.runtime.sources import ArraySource as TArray
from gnsstpu_torch.runtime.telemetry import Telemetry as TTelemetry
from test_pipeline import LateSvSource
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import to_port

GPS = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
GLO = SignalConfig(signal="glonass_l1of", if_freq=0.0, fs=4.096e6,
                   code_freq=0.511e6, code_length=511, fdma_step=562.5e3,
                   complex_iq=True)
STEP = 562.5e3
CASES = {
    # (signal, satellites, source ms, acquisition, manager options, run ms)
    "cdma_serial": (
        GPS,
        [SatParams(prn=5, doppler_hz=900.0, code_phase_chips=200.5,
                   cn0_dbhz=47.0),
         SatParams(prn=12, doppler_hz=-1500.0, code_phase_chips=700.25,
                   cn0_dbhz=46.0)],
        1600,
        AcqConfig(doppler_band=4e3, coherent_ms=10, noncoherent=3,
                  threshold=1.8, prn_list=(5, 12), fine_doppler_ms=10,
                  doppler_step=100.0),
        dict(epoch_ms=20, reacq_period_ms=600, sync_every=1),
        800),
    "fdma_prefetch": (
        GLO,
        [SatParams(prn=5, doppler_hz=1100.0, if_offset_hz=-3 * STEP,
                   code_phase_chips=120.5, cn0_dbhz=47.0),
         SatParams(prn=12, doppler_hz=-1700.0, if_offset_hz=4 * STEP,
                   code_phase_chips=333.25, cn0_dbhz=46.0)],
        1700,
        AcqConfig(doppler_band=4e3, coherent_ms=4, noncoherent=8,
                  threshold=1.8, prn_list=(5, 12), fine_doppler_ms=10,
                  doppler_step=125.0),
        dict(epoch_ms=20, reacq_period_ms=500, sync_every=1,
             prefetch=True),
        700),
}


@functools.lru_cache(maxsize=None)
def _samples(case):
    """The case's signal, made once for both managers."""
    sig, sats, src_ms = CASES[case][:3]
    x = LateSvSource(sig, sats, src_ms, switch_ms=400)
    return x.read(0, len(x))


def _run(cls, case):
    sig, sats, src_ms, acq, opts, n_ms = CASES[case]
    samples = _samples(case).copy()
    cfg = ReceiverConfig(signal=sig, acq=acq, track=TrackConfig(dll_bw=1.0),
                         n_channels=3)
    sink = io.StringIO()
    if cls is TManager:
        mgr = cls(TArray(samples), to_port(cfg), device="cpu",
                  telemetry=TTelemetry(sink=sink), cn0_drop_dbhz=35.0,
                  prn_pool=[5, 12], engine="gather", **opts)
    else:
        mgr = cls(JArray(samples), cfg, telemetry=Telemetry(sink=sink),
                  cn0_drop_dbhz=35.0, prn_pool=[5, 12], engine="gather",
                  **opts)
    assert mgr._chunk_len < mgr._acq_samples_needed_chunk()
    finished = []
    apply = mgr._finish_chunk_acq

    def record(metrics, want, base, *a, **kw):
        finished.append((np.array(metrics), base))
        return apply(metrics, want, base, *a, **kw)

    mgr._finish_chunk_acq = record
    mgr.run(n_ms)
    lines = [json.loads(ln) for ln in sink.getvalue().splitlines()]
    return mgr, lines, finished


@pytest.mark.parametrize("case", sorted(CASES))
def test_weak_tier_matches_reference(case, monkeypatch):
    if case.startswith("fdma"):
        monkeypatch.setattr(jfft, "acquire_cube", functools.partial(
            jfft.acquire_cube, prn_chunk=1, fft_mode="mm"))
    jm, jl, jf = _run(JManager, case)
    tm, tl, tf = _run(TManager, case)
    starts = [[(e["prn"], e["epoch_ms"], e["code_phase"], e["doppler_hz"])
               for e in lines if e.get("what") == "channel_start"]
              for lines in (tl, jl)]
    assert starts[0] == starts[1]
    assert any(p == 5 and ms == 0 for p, ms, _, _ in starts[0])
    late = [ms for p, ms, _, _ in starts[0] if p == 12]
    assert late and late[0] >= 400
    for lines in (tl, jl):
        host = [e["epoch_ms"] for e in lines if e.get("stage") == "acquire"]
        assert host == [0]
    assert len(tf) == len(jf) >= 1
    for (got, gb), (want, wb) in zip(tf, jf):
        assert gb == wb
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
        np.testing.assert_array_equal(got[1:], want[1:])
    assert {s.prn for s in tm.slots if s.prn} == {5, 12}


def test_weak_accumulation_refuses_sub_window_advance():
    sats = CASES["cdma_serial"][1]
    buf = np.asarray(IFSimulator(GPS, sats, noise_sigma=1.0,
                                 seed=3).generate(120))
    cfg = ReceiverConfig(
        signal=GPS,
        acq=AcqConfig(doppler_band=4e3, coherent_ms=10, noncoherent=15,
                      threshold=1.8, prn_list=(5, 12), fine_doppler_ms=10,
                      doppler_step=100.0),
        track=TrackConfig(dll_bw=1.0), n_channels=3)
    mgr = TManager(TArray(buf), to_port(cfg), device="cpu",
                   telemetry=TTelemetry(sink=io.StringIO()), epoch_ms=10,
                   sync_every=1)
    adv = mgr._espc * mgr.sync_every
    assert adv < (cfg.acq.coherent_ms + 1) * GPS.samples_per_code
    assert mgr._make_acq_wk() is None
    assert mgr._wk_step(None, 0, 10 ** 9)[0] == "unsupported"
