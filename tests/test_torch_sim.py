"""Port IF simulator and scenarios vs gnsstpu.sim.

With noise_sigma=0 both synthesize the same noise-free signal from the
same f64 host bookkeeping and f32 device ramps: agree to 1e-4. The noise
comes from a torch.Generator (not jax.random), so with noise only its
statistics are checked. The GPS, GLONASS and BeiDou scenarios give the
same SatParams (to 1e-12 relative) and the same quantized ephemerides,
field for field; a 1.5 s BeiDou slice runs both managers on the same
samples, the port's with its gather engine and with K1's twin.
"""

import dataclasses
import io

import numpy as np
import pytest
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


def _same_sats(a, b):
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        assert sa.prn == sb.prn
        for f in ("doppler_hz", "doppler_rate", "if_offset_hz",
                  "code_phase_chips", "carrier_phase", "cn0_dbhz"):
            np.testing.assert_allclose(getattr(sb, f), getattr(sa, f),
                                       rtol=1e-12, atol=0, err_msg=f)
        np.testing.assert_array_equal(sa.nav_bits, sb.nav_bits)


def _same_ephs(a, b):
    assert sorted(a) == sorted(b)
    for prn in a:
        assert type(b[prn]).__name__ == type(a[prn]).__name__
        assert dataclasses.asdict(b[prn]) == dataclasses.asdict(a[prn])


GLO = SignalConfig(signal="glonass_l1of", if_freq=0.0, fs=8.192e6,
                   code_freq=0.511e6, code_length=511, fdma_step=562.5e3,
                   complex_iq=True)
BDS = SignalConfig(signal="beidou_b1i", if_freq=0.0, fs=4.096e6,
                   code_freq=2.046e6, code_length=2046, complex_iq=True)


def test_glonass_scenario_matches_reference():
    """make_glonass_constellation and build_scenario_glonass on
    tests/test_glonass.py's live sky (6 satellites, tb 675)."""
    from gnsstpu.sim import scenario as jscen
    from test_glonass import GFIX_RECV, GFIX_T0, GFIX_TB

    jg = jscen.make_glonass_constellation(GFIX_RECV, GFIX_TB, n=6)
    tg = tscen.make_glonass_constellation(GFIX_RECV, GFIX_TB, n=6)
    _same_ephs(jg, tg)
    assert tscen.signal_delay_gl(tg[5], GFIX_RECV, GFIX_T0) == \
        jscen.signal_delay_gl(jg[5], GFIX_RECV, GFIX_T0)
    a, qa = jscen.build_scenario_glonass(GLO, jg, GFIX_RECV, GFIX_T0,
                                         duration_s=12.0, cn0_dbhz=48.0,
                                         n_strings=6)
    b, qb = tscen.build_scenario_glonass(to_port(GLO), tg, GFIX_RECV,
                                         GFIX_T0, duration_s=12.0,
                                         cn0_dbhz=48.0, n_strings=6)
    _same_sats(a, b)
    _same_ephs(qa, qb)
    assert sorted(s.if_offset_hz for s in b) != [0.0] * len(b)


def test_beidou_scenario_matches_reference():
    """build_scenario_beidou on tests/test_beidou.py's sky, and
    beidou_constellation against make_bd_constellation +
    build_scenario_beidou on the same arguments."""
    from gnsstpu.sim import scenario as jscen
    from test_beidou import BD_RECV, BD_SOW0, make_bd_constellation

    duration = 28.6
    jephs = make_bd_constellation(5)
    a, qa = jscen.build_scenario_beidou(BDS, jephs, BD_RECV, BD_SOW0,
                                        duration_s=duration, cn0_dbhz=48.0,
                                        n_subframes=5)
    b, qb = tscen.build_scenario_beidou(
        to_port(BDS), {p: to_port(e) for p, e in jephs.items()}, BD_RECV,
        BD_SOW0, duration_s=duration, cn0_dbhz=48.0, n_subframes=5)
    _same_sats(a, b)
    _same_ephs(qa, qb)

    n_sf = int(np.ceil(duration / 6.0)) + 1
    a, qa = jscen.build_scenario_beidou(BDS, jephs, BD_RECV, BD_SOW0,
                                        duration_s=duration, cn0_dbhz=48.0,
                                        n_subframes=n_sf)
    b, prns, recv, qb = tscen.beidou_constellation(
        to_port(BDS), 5, duration_s=duration, cn0_dbhz=48.0)
    assert prns == sorted(jephs)
    np.testing.assert_array_equal(recv, BD_RECV)
    assert tscen.BEIDOU_SOW0 == BD_SOW0
    _same_sats(a, b)
    _same_ephs(qa, qb)
    # Every satellite above 15 degrees: the reference's 5 and more.
    sky = tscen.beidou_constellation(to_port(BDS), None, duration_s=2.0)[1]
    assert set(prns) < set(sky)


#: For each port engine, the reference engine it is held to on the
#: BeiDou slice and the superepoch length: the exact scan ('gather'), and
#: for K1 the scan in table mode, whose 1/64-chip code rows K1 shares
#: (tests/test_track_kernel.py; the reference's own K1 has only the
#: four-quadrant FLL). K1 runs one-epoch superepochs: in a 4-epoch one
#: PRN 28's cursor drifts to sample -1 of its third epoch's window, where
#: the reference's scan reads the window's tail for one block
#: (dynamic_slice) and K1 reads a zero before the window, so the loops
#: part there (ROADMAP.md, queue 3, "Serial-superepoch cursor at -1").
BEIDOU_REFERENCE = {"gather": ("gather", 4), "fused": ("table", 1)}


@pytest.fixture(scope="module", params=sorted(BEIDOU_REFERENCE))
def beidou_slice(request):
    """1.5 s of the BeiDou B1I scenario (4.096 Msps, the reference's
    5-satellite sky, seed 17), its config, and the reference's manager
    run on it as BEIDOU_REFERENCE holds the port's engine to (fll_disc
    'atan' in both)."""
    from gnsstpu.config import AcqConfig, ReceiverConfig, TrackConfig
    from gnsstpu.runtime.manager import ChannelManager as JManager
    from gnsstpu.runtime.sources import ArraySource as JArray
    from gnsstpu.runtime.telemetry import Telemetry
    from gnsstpu.sim.scenario import build_scenario_beidou
    from test_beidou import BD_RECV, BD_SOW0, make_bd_constellation

    ephs = make_bd_constellation(5)
    sats, _ = build_scenario_beidou(BDS, ephs, BD_RECV, BD_SOW0,
                                    duration_s=1.6, cn0_dbhz=48.0)
    x = np.asarray(JSim(BDS, sats, noise_sigma=1.0, seed=17).generate(1560))
    cfg = ReceiverConfig(
        signal=BDS,
        acq=AcqConfig(doppler_band=12e3, coherent_ms=1, threshold=2.0,
                      doppler_step=125.0, prn_list=tuple(sorted(ephs))),
        track=TrackConfig(dll_bw=1.5, pll_bw=25.0, fll_bw=150.0,
                          fll_disc="atan", aid_div=1561.098e6 / 2.046e6),
        n_channels=3)
    engine, sync_every = BEIDOU_REFERENCE[request.param]
    kw = dict(epoch_ms=100, reacq_period_ms=2000, confirm_epochs=12,
              sync_every=sync_every)
    jm = JManager(JArray(x.copy()), cfg, telemetry=Telemetry(
        sink=io.StringIO()), engine=engine, **kw)
    return request.param, x, cfg, kw, sorted(ephs), jm, jm.run(1500)


def test_beidou_live_slice_matches_reference(beidou_slice):
    """The port's manager on the BeiDou slice (one case per port engine)
    against the reference's scan: the same slot assignments at every
    epoch. 'gather' against the exact scan: prompts / Doppler to 1e-4 of
    their scale (test_torch_manager.py's gather tolerances). 'fused' (K1's
    twin, its two-quadrant 'atan' FLL) against the scan in table mode, in
    one-epoch superepochs:
    prompts to rtol 2e-3, atol 2, Doppler to 0.05 Hz and the same sample
    positions (test_torch_manager.py's fused tolerances)."""
    from gnsstpu_torch.runtime.manager import ChannelManager as TManager
    from gnsstpu_torch.runtime.sources import ArraySource as TArray
    from gnsstpu_torch.runtime.telemetry import Telemetry as TTelemetry

    engine, x, cfg, kw, prns, jm, jr = beidou_slice
    tm = TManager(TArray(x.copy()), to_port(cfg), device="cpu",
                  telemetry=TTelemetry(sink=io.StringIO()), engine=engine,
                  **kw)
    tr = tm.run(1500)
    assert tm.engine == engine
    assert len(tr) == len(jr) == 15
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a.prn, b.prn)
        if engine == "gather":
            np.testing.assert_allclose(a.cn0_dbhz, b.cn0_dbhz, atol=1e-2)
    live = [p for p in tr[-1].prn if p]
    assert len(live) == 3 and set(live) <= set(prns)
    assert [(s.prn, s.state.value) for s in tm.slots] == \
        [(s.prn, s.state.value) for s in jm.slots]
    for prn in live:
        h, g = tm.prompt_stream(prn), jm.prompt_stream(prn)
        if engine == "gather":
            for lane in ("i_p", "q_p", "carr_doppler", "abs_sample"):
                scale = float(np.max(np.abs(g[lane])))
                np.testing.assert_allclose(h[lane], g[lane], rtol=1e-4,
                                           atol=1e-4 * scale, err_msg=lane)
            continue
        for lane in ("i_p", "q_p"):
            np.testing.assert_allclose(h[lane], g[lane], rtol=2e-3,
                                       atol=2.0, err_msg=lane)
        np.testing.assert_allclose(h["carr_doppler"], g["carr_doppler"],
                                   rtol=0, atol=0.05)
        np.testing.assert_array_equal(h["abs_sample"], g["abs_sample"])
