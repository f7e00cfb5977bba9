"""The port's offline receiver (runtime/receiver.py) vs gnsstpu's, on the
CPU.

  * run_receiver of both packages on one short GPS L1 C/A recording (3
    SVs at 47 dB-Hz, 1.2 s at 2.048 Msps, made with gnsstpu's
    IFSimulator): the same acquisition results, the same channels, and
    tracks at tests/test_track_kernel.py's fused-against-scan tolerances
    (abs_sample after the port's half-slip term, tracking.driver).
    The port's receiver runs kernel K1's plain twin ('auto' is the fused
    engine on every device); the reference's runs its scan engine,
    switched here to 'table' mode (the engine whose 1/64-chip rows K1
    shares) by patching its driver's engine choice in the test, since its
    'auto' picks the exact 'gather' scan off the TPU.
  * decode_nav and navigate_from_anchors of both packages on records that
    yield ephemerides and fixes, built in about a second without a
    tracker from tests/test_full_chain.py's GPS scenario (6 SVs, 24 s)
    and tests/test_galileo.py's Galileo one (5 SVs, 13 s): each channel's
    prompts are its nav symbols (one per bit period) with seeded noise, abs_sample the stream sample where each code
    period ends under the simulator's own code-phase model, carr_freq its
    Doppler. Both halves are numpy code on each package's copy of
    gnsstpu.nav, so every output must be identical.
"""

import numpy as np
import pytest

from gnsstpu.config import (AcqConfig, NavConfig, ReceiverConfig,
                            SignalConfig, TrackConfig)
from gnsstpu.nav import geodesy
from gnsstpu.runtime import receiver as jrec
from gnsstpu.runtime.sources import ArraySource as JArraySource
from gnsstpu.signals.registry import get_signal
from gnsstpu.sim import IFSimulator, SatParams
from gnsstpu.sim.scenario import build_scenario
from gnsstpu.tracking import driver as jdriver
from gnsstpu_torch.ops import track_kernel as tk
from gnsstpu_torch.runtime import receiver as trec
from gnsstpu_torch.runtime.sources import ArraySource
from gnsstpu_torch.tracking import driver as tdriver
from test_full_chain import RECV_ECEF, TOW0_6S, visible_ephs
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import to_port

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
CFG = ReceiverConfig(
    signal=SIG,
    acq=AcqConfig(doppler_band=6e3, coherent_ms=2, threshold=2.5),
    track=TrackConfig(dll_bw=1.0, pll_bw=25.0, fll_bw=250.0),
    nav=NavConfig(sol_period_ms=500, elevation_mask_deg=10.0,
                  use_tropo=False),
    n_channels=4, ms_to_process=1200)
SATS = [SatParams(prn=p, doppler_hz=d, code_phase_chips=c, cn0_dbhz=47.0,
                  nav_bits=np.random.default_rng(p).choice([-1.0, 1.0], 80))
        for p, d, c in ((5, 1500.0, 120.25), (12, -2300.0, 640.5),
                        (29, 400.0, 910.75))]
ACCS = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l")


@pytest.fixture(scope="module")
def samples():
    return np.asarray(IFSimulator(SIG, SATS, noise_sigma=1.0,
                                  seed=21).generate(1250))


def test_run_receiver_matches_reference(samples, monkeypatch):
    monkeypatch.setattr(jdriver, "resolve_engine",
                        lambda m="auto": "table" if m == "auto" else m)
    ref = jrec.run_receiver(JArraySource(samples), CFG)
    before = tk.LAUNCHES["track_chunk_fused"]
    got = trec.run_receiver(ArraySource(samples), to_port(CFG),
                            device="cpu")
    assert tk.LAUNCHES["track_chunk_fused"] == before
    for name in ("peak_metric", "code_phase", "carr_freq", "detected"):
        a, b = getattr(got.acq, name), np.asarray(getattr(ref.acq, name))
        if name == "peak_metric":
            np.testing.assert_allclose(a, b, rtol=1e-3)
        else:
            np.testing.assert_array_equal(a, b)
    assert got.acq.detected_prns() == ref.acq.detected_prns() == [5, 12, 29]
    assert ([vars(c) for c in got.channels]
            == [vars(c) for c in ref.channels])
    assert got.track.i_p.shape == (3, 1200)
    np.testing.assert_array_equal(got.track.prn, ref.track.prn)
    spchip = SIG.fs / SIG.code_freq
    # The port's half-slip term (tracking.driver.replica_slip_samples),
    # which the reference's drivers lack, at the nominal block length.
    slip = tdriver.replica_slip_samples(
        ref.track.code_freq - SIG.code_freq,
        np.full(ref.track.code_freq.shape, SIG.samples_per_code),
        SIG.code_freq)
    np.testing.assert_allclose(got.track.abs_sample,
                               ref.track.abs_sample + slip, rtol=0,
                               atol=5e-4 * spchip)
    for name in ACCS:
        np.testing.assert_allclose(getattr(got.track, name),
                                   getattr(ref.track, name), rtol=2e-3,
                                   atol=2.0, err_msg=name)
    np.testing.assert_allclose(got.track.carr_freq, ref.track.carr_freq,
                               rtol=0, atol=0.05)
    # 1.2 s holds no whole subframe: nothing decoded, no fix, on both.
    assert got.ephs == ref.ephs == {} and got.nav is ref.nav is None
    assert set(got.stage_s) == {"acquire", "track", "decode_nav"}


def _record(sig, sats, n_ms, seed):
    """(i_p, abs_sample, carr_freq), each [C, n_ms], of a tracker that
    followed `sats` perfectly: code period m of channel c ends at
    abs_sample[c, m] under the simulator's code-phase model
    (gnsstpu/sim/generator.py: chips(t) = f_code t (1 + (fd + rate t / 2)
    / f_carr) - code_phase_chips), and its prompt is its nav bit."""
    sd = get_signal(sig.signal)
    rng = np.random.default_rng(seed)
    m = np.arange(1, n_ms + 1, dtype=np.float64)
    i_p, abs_s, carr = [], [], []
    for s in sats:
        f_carr = sd.carrier_freq(s.prn)
        a = sig.code_freq * 0.5 * s.doppler_rate / f_carr
        b = sig.code_freq * (1.0 + s.doppler_hz / f_carr)
        c = m * sig.code_length + s.code_phase_chips
        t_end = 2.0 * c / (b + np.sqrt(b * b + 4.0 * a * c))
        abs_s.append(t_end * sig.fs)
        t_start = np.concatenate([[t_end[0] - 1e-3], t_end[:-1]])
        carr.append(sig.if_freq + s.doppler_hz + s.doppler_rate * t_start)
        bits = np.asarray(s.nav_bits)[(m.astype(np.int64) - 1)
                                      // sd.bit_len_codes]
        i_p.append(600.0 * bits + rng.normal(0.0, 40.0, n_ms))
    return (np.array(i_p, np.float32), np.array(abs_s),
            np.array(carr))


def _gps_sky():
    """tests/test_full_chain.py's scenario: (sig, sats, truth ephemeris
    PRNs, receiver, code periods, the limits of its fix)."""
    sats = build_scenario(SIG, visible_ephs(6), RECV_ECEF, TOW0_6S,
                          duration_s=24.0, cn0_dbhz=47.0)
    return SIG, sats, [s.prn for s in sats], RECV_ECEF, 24000, (20.0, 60.0)


def _galileo_sky():
    """tests/test_galileo.py:199-242's scenario (5 SVs, 3,250 periods of
    4 ms), its limits 25 / 80 m."""
    from gnsstpu.sim.scenario import build_scenario_galileo
    from test_galileo import (GAL_NPER, GAL_RECV, GAL_TOW0,
                              make_gal_constellation)
    from test_galileo import SIG as GSIG

    sats, qephs = build_scenario_galileo(
        GSIG, make_gal_constellation(5), GAL_RECV, GAL_TOW0,
        duration_s=GAL_NPER * GSIG.code_period_s, cn0_dbhz=48.0, n_pages=6)
    return GSIG, sats, sorted(qephs), GAL_RECV, GAL_NPER, (25.0, 80.0)


@pytest.fixture(scope="module", params=["gps_l1ca", "galileo_e1b"])
def record(request):
    sig, sats, truth, recv, n_ms, limits = (
        _gps_sky() if request.param == "gps_l1ca" else _galileo_sky())
    i_p, abs_s, carr = _record(sig, sats, n_ms, seed=3)
    z = np.zeros_like(i_p)
    fields = dict(prn=np.array([s.prn for s in sats]),
                  status=np.ones(len(sats), bool), i_e=z, q_e=z, i_p=i_p,
                  q_p=z, i_l=z, q_l=z, carr_freq=carr,
                  code_freq=np.full(i_p.shape, sig.code_freq),
                  abs_sample=abs_s, dll_disc=z, dll_disc_filt=z,
                  pll_disc=z, pll_disc_filt=z)
    chans = [dict(prn=s.prn, code_phase=0, doppler_hz=s.doppler_hz)
             for s in sats]
    return sig, truth, recv, n_ms, limits, fields, chans


def test_decode_and_navigate_match_reference(record):
    sig, truth, recv, n_ms, limits, fields, chans = record
    nav = NavConfig(sol_period_ms=500, elevation_mask_deg=10.0,
                    use_tropo=False)
    outs = []
    for rec, drv, s, navc in (
            (jrec, jdriver, sig, nav),
            (trec, tdriver, to_port(sig), to_port(nav))):
        tr = drv.TrackResults(**{k: v.copy() for k, v in fields.items()})
        ch = [drv.ChannelInit(**c) for c in chans]
        syncs, anchors, e, tows, fns = rec.decode_nav(tr, ch, s)
        sol = rec.navigate_from_anchors(tr, ch, anchors, e, s, navc,
                                        n_ms, fns)
        outs.append((syncs, anchors, e, tows, sol))
    (js, ja, je, jt, jn), (ts, ta, te, tt, tn) = outs
    # Not vacuous: every SV's ephemeris and fixes.
    assert sorted(je) == sorted(truth)
    if sig.signal == "gps_l1ca":
        assert set(jt.values()) == {TOW0_6S * 6.0}
    assert jn is not None and jn.valid.sum() >= 8
    # The port's decode and navigation: the reference's outputs exactly.
    assert [vars(x) for x in ts] == [vars(x) for x in js]
    assert [vars(a) for a in ta] == [vars(a) for a in ja]
    assert sorted(te) == sorted(je) and tt == jt
    for prn in je:
        assert vars(te[prn]) == vars(je[prn]), prn
    for name, ref in vars(jn).items():
        got = getattr(tn, name)
        if isinstance(ref, np.ndarray):
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            assert got == ref, name
    # The fix is the scenario's receiver, within the reference test's
    # limits.
    err = np.linalg.norm(np.stack([tn.x, tn.y, tn.z], 1)[tn.valid]
                         - recv, axis=1)
    assert err.mean() < limits[0] and err.max() < limits[1]
    lat, lon, _ = geodesy.cart2geo(*recv, 5)
    assert abs(np.mean(tn.latitude[tn.valid]) - lat) < 1e-3
