"""The benchmark's frozen traffic generator against the port's simulator
it was copied from: the same parameters give the same noise-free samples,
codes, LNAV bits and L3OC coded bits."""

import numpy as np
import pytest
import torch

from gnsstpu_torch.config import SignalConfig
from gnsstpu_torch.nav import geodesy as pgeo
from gnsstpu_torch.nav import lnav as plnav
from gnsstpu_torch.nav import orbits as porb
from gnsstpu_torch.nav.types import Ephemeris as PEph
from gnsstpu_torch.nav.viterbi import conv_encode as pconv
from gnsstpu_torch.signals import glonass_l3 as pl3
from gnsstpu_torch.signals.gps_l1ca import generate_ca_code
from gnsstpu_torch.sim import IFSimulator, SatParams
from gnsstpu_torch.sim import scenario as pscen

from portbench import plan
from portbench.gen import codes, ifsim, lnav, orbit
from portbench.gen import sky as skymod

GPS = plan.load_json(plan.HERE / "configs" / "gps_l1ca_12ch.json")
L3 = plan.load_json(plan.HERE / "configs" / "glonass_l3oc_12ch.json")


def _port_signal(cfg: dict) -> SignalConfig:
    s = cfg["signal"]
    return SignalConfig(signal=s["signal"], if_freq=s["if_freq"], fs=s["fs"],
                        code_freq=s["code_freq"],
                        code_length=s["code_length"], complex_iq=True)


@pytest.mark.parametrize("prn", [1, 7, 19, 32, 37])
def test_ca_code_is_the_ports(prn):
    np.testing.assert_array_equal(codes.ca_code(prn), generate_ca_code(prn))


@pytest.mark.parametrize("prn", [1, 3, 30, 35, 63])
def test_l3_code_is_the_ports(prn):
    np.testing.assert_array_equal(codes.l3_code(prn),
                                  pl3.generate_l3_code(prn))
    np.testing.assert_array_equal(codes.NH10, pl3.NH10)
    np.testing.assert_array_equal(codes.BARKER5, pl3.BARKER5)


def test_l3_coded_bits_are_the_ports():
    from gnsstpu_torch.nav import glonass_l3 as l3nav

    bits = np.random.default_rng(5).integers(0, 2, 24).astype(np.int8)
    np.testing.assert_array_equal(
        codes.conv_encode(bits),
        pconv(bits, polys=l3nav.L3_POLYS, invert=l3nav.L3_INVERT))


def test_lnav_frames_are_the_ports():
    for k, eph in enumerate(skymod.gps_orbits()[:3]):
        peph = PEph(**vars(eph))
        np.testing.assert_array_equal(
            lnav.encode_frames(eph, tow0=44400 + k, n_subframes=7),
            plnav.encode_frames(peph, tow0=44400 + k, n_subframes=7))


def test_orbits_and_geodesy_are_the_ports():
    ephs = skymod.gps_orbits()
    pephs = [PEph(**vars(e)) for e in ephs]
    for t in (266400.0, 266400.0 - 1800.0, 266400.0 + 1799.0):
        p, c = orbit.satpos(t, ephs)
        pp, pc = porb.satpos(t, pephs)
        np.testing.assert_array_equal(p, pp)
        np.testing.assert_array_equal(c, pc)
        recv = skymod.GPS_RECV_ECEF
        for a, b in zip(orbit.topocent(recv, p - recv),
                        pgeo.topocent(recv, pp - recv)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        orbit.e_r_corr(np.array([0.07, 0.08]), p[:2]),
        pgeo.e_r_corr(np.array([0.07, 0.08]), pp[:2]))
    assert orbit.cart2geo(*recv) == pgeo.cart2geo(*recv, 5)
    assert orbit.signal_delay(ephs[4], recv, 266000.0) == \
        pscen.signal_delay(pephs[4], recv, 266000.0)


def test_gps_sky_at_the_reference_time_is_bench_constellation():
    """At the ephemerides' reference time the sky picks bench_constellation's
    satellites with its Dopplers and delays, and twice its Doppler rate:
    the copy takes the delay's second derivative, which the port's
    scenario halves (see the next test)."""
    sig = skymod.signal_of(GPS)
    traffic = {"recording_ms": 44000,
               "sky": {"n_sats": 11, "n_absent": 2, "cn0_dbhz": 47.0,
                       "start_span_6s": 0, "clock_bias_max_s": 0.0}}
    sky = skymod.gps_sky(sig, traffic, seed=3)
    psats, pprns, _ = pscen.bench_constellation(_port_signal(GPS), 11, 45.0)
    assert sky.prns == pprns
    for a, b in zip(sky.sats, psats):
        assert (a.prn, a.doppler_hz, a.doppler_rate, a.code_phase_chips) == \
            (b.prn, b.doppler_hz, 2 * b.doppler_rate, b.code_phase_chips)
        # The subframes after the filler are the same LNAV bits.
        np.testing.assert_array_equal(a.nav_bits[100:], b.nav_bits[100:])


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_gps_streams_follow_the_geometry(seed):
    """Each stream's code delay, as the IF simulator integrates its
    Doppler and rate, stays within 5 cm of the geometric delay (Earth's
    turn included) over the whole recording; the receiver clock offset
    and the satellite clock are common to every instant."""
    traffic = plan.load_json(plan.HERE / "traffic" / "hostfed_44s.json")
    sig = skymod.signal_of(GPS)
    sky = skymod.gps_sky(sig, traffic, seed)
    rng = np.random.default_rng([seed, 1])
    tow0 = 6.0 * (skymod.GPS_TOW0_6S + int(rng.integers(-300, 301)))
    t_r0 = tow0 - 2.0
    for sat in sky.sats:
        eph = sky.ephs[sat.prn]
        tau0 = orbit.signal_delay(eph, sky.recv_ecef, t_r0)
        for t in (7.0, 22.5, 38.0, 45.0):
            model = tau0 - (sat.doppler_hz * t + 0.5 * sat.doppler_rate
                            * t * t) / sig.carrier_hz
            true = orbit.signal_delay(eph, sky.recv_ecef, t_r0 + t)
            assert abs(model - true) * orbit.SPEED_OF_LIGHT < 0.05


@pytest.mark.parametrize("cfg,n_ms", [(GPS, 3), (L3, 2)])
def test_noise_free_samples_are_the_ports(cfg, n_ms):
    sig = skymod.signal_of(cfg)
    rng = np.random.default_rng(9)
    prns = [3, 17, 25] if sig.name == "gps_l1ca" else [7, 39]
    sats = [skymod.Sat(prn=p, doppler_hz=float(rng.uniform(-3e3, 3e3)),
                       doppler_rate=float(rng.uniform(-1, 1)),
                       code_phase_chips=float(rng.uniform(0, 900)),
                       carrier_phase=float(rng.uniform(0, 6)),
                       cn0_dbhz=48.0,
                       nav_bits=rng.choice([-1.0, 1.0], 40))
            for p in prns]
    sky = skymod.Sky(signal=sig, sats=sats, prns=prns, absent=[])
    mine = ifsim.IFSim(sky, noise_sigma=1.0, seed=1, device="cpu")
    mine.noise_sigma = 0.0
    port = IFSimulator(_port_signal(cfg),
                       [SatParams(**vars(s)) for s in sats],
                       noise_sigma=1.0, seed=1, device="cpu")
    port.noise_sigma = 0.0
    for ms0 in (0, 5):
        torch.testing.assert_close(mine.generate(n_ms, ms0),
                                   port.generate_tensor(n_ms, ms0),
                                   rtol=0, atol=0)


def test_sm2_packing_is_the_ports():
    from gnsstpu_torch.ops import unpack as up

    x = torch.randn(4096, 2, generator=torch.Generator().manual_seed(2)) * 2
    np.testing.assert_array_equal(ifsim.pack_sm2(x).numpy(),
                                  up.pack_np(x.numpy(), "sm2"))


def test_recording_is_reproducible_from_a_large_seed():
    sky = skymod.make_sky(L3, plan.load_json(
        plan.HERE / "traffic" / "resident_9s.json"), 2 ** 31 + 12345)
    sky.sats = sky.sats[:2]
    a = ifsim.recording(sky, 2, 2 ** 31 + 12345, "cpu")
    b = ifsim.recording(sky, 2, 2 ** 31 + 12345, "cpu")
    assert a.dtype == torch.uint8 and a.numel() == 2 * 24000 // 2
    assert torch.equal(a, b)
