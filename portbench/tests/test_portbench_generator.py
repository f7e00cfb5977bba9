"""The benchmark's frozen traffic generator against the port's simulator
it was copied from: the same parameters give the same noise-free samples,
codes, LNAV bits, L3OC coded bits and Galileo I/NAV symbols; and the two
cells' skies and recordings as they were made before each signal became a
module of its own (signals/<signal>.py), pinned by their digests."""

import hashlib

import numpy as np
import pytest
import torch

from gnsstpu_torch.config import SignalConfig
from gnsstpu_torch.nav import galileo as pgal
from gnsstpu_torch.nav import geodesy as pgeo
from gnsstpu_torch.nav import lnav as plnav
from gnsstpu_torch.nav import orbits as porb
from gnsstpu_torch.nav.types import Ephemeris as PEph
from gnsstpu_torch.nav.viterbi import conv_encode as pconv
from gnsstpu_torch.signals import galileo_e1 as pe1
from gnsstpu_torch.signals import glonass_l3 as pl3
from gnsstpu_torch.signals.gps_l1ca import generate_ca_code
from gnsstpu_torch.sim import IFSimulator, SatParams
from gnsstpu_torch.sim import scenario as pscen

from portbench import plan
from portbench.gen import codes, ifsim, lnav, orbit
from portbench.gen import sky as skymod

DATA = plan.HERE / "tests" / "data"
GPS = plan.load_json(plan.HERE / "configs" / "gps_l1ca_12ch.json")
L3 = plan.load_json(plan.HERE / "configs" / "glonass_l3oc_12ch.json")
GAL = plan.load_json(DATA / "configs" / "galileo_e1b_12ch.json")
GAL_TRAFFIC = plan.load_json(DATA / "traffic" / "galileo_20s.json")
GPS_SIGNAL = plan.signal("gps_l1ca")
GAL_SIGNAL = plan.signal("galileo_e1b")


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
    for k, eph in enumerate(GPS_SIGNAL.gps_orbits()[:3]):
        peph = PEph(**vars(eph))
        np.testing.assert_array_equal(
            lnav.encode_frames(eph, tow0=44400 + k, n_subframes=7),
            plnav.encode_frames(peph, tow0=44400 + k, n_subframes=7))


def test_orbits_and_geodesy_are_the_ports():
    ephs = GPS_SIGNAL.gps_orbits()
    pephs = [PEph(**vars(e)) for e in ephs]
    for t in (266400.0, 266400.0 - 1800.0, 266400.0 + 1799.0):
        p, c = orbit.satpos(t, ephs)
        pp, pc = porb.satpos(t, pephs)
        np.testing.assert_array_equal(p, pp)
        np.testing.assert_array_equal(c, pc)
        recv = GPS_SIGNAL.GPS_RECV_ECEF
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
    sky = GPS_SIGNAL.sky(sig, traffic, seed=3)
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
    sky = GPS_SIGNAL.sky(sig, traffic, seed)
    rng = np.random.default_rng([seed, 1])
    tow0 = 6.0 * (GPS_SIGNAL.GPS_TOW0_6S
                  + int(rng.integers(-300, 301)))
    t_r0 = tow0 - 2.0
    for sat in sky.sats:
        eph = sky.ephs[sat.prn]
        tau0 = orbit.signal_delay(eph, sky.recv_ecef, t_r0)
        for t in (7.0, 22.5, 38.0, 45.0):
            model = tau0 - (sat.doppler_hz * t + 0.5 * sat.doppler_rate
                            * t * t) / sig.carrier_hz
            true = orbit.signal_delay(eph, sky.recv_ecef, t_r0 + t)
            assert abs(model - true) * orbit.SPEED_OF_LIGHT < 0.05


@pytest.mark.parametrize("cfg,n_ms,prns", [(GPS, 3, [3, 17, 25]),
                                           (L3, 2, [7, 39]),
                                           (GAL, 20, [4, 11, 30])])
def test_noise_free_samples_are_the_ports(cfg, n_ms, prns):
    sig = skymod.signal_of(cfg)
    rng = np.random.default_rng(9)
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


@pytest.mark.parametrize("prn", range(1, 51))
def test_e1b_composite_code_is_the_ports(prn):
    np.testing.assert_array_equal(GAL_SIGNAL.code(prn),
                                  pe1.composite_code(prn))


def _port_galileo_eph(eph) -> pgal.GalileoEphemeris:
    return pgal.GalileoEphemeris(**{k: getattr(eph, k) for k in vars(eph)})


def test_inav_symbols_are_the_ports():
    for k, eph in enumerate(GAL_SIGNAL.orbits()[:3]):
        np.testing.assert_array_equal(
            GAL_SIGNAL.encode_frames(eph, 351000 + 2 * k, 7),
            pgal.encode_frames(_port_galileo_eph(eph), tow0=351000 + 2 * k,
                               n_pages=7))


def test_galileo_orbits_are_the_ports():
    ephs = GAL_SIGNAL.orbits()
    pephs = [_port_galileo_eph(e) for e in ephs]
    for t in (351000.0, 351000.0 - 1800.0, 351000.0 + 1799.0):
        p, c = orbit.satpos(t, [GAL_SIGNAL.kepler(e) for e in ephs],
                            **GAL_SIGNAL.ORBIT)
        pp, pc = pgal.satpos_gal(t, pephs)
        np.testing.assert_array_equal(p, pp)
        np.testing.assert_array_equal(c, pc)


def test_galileo_sky_at_the_reference_time_is_galileo_constellation():
    """At the ephemerides' reference time the sky picks
    galileo_constellation's satellites with its Dopplers, delays and
    ephemerides as the pages carry them, and twice its Doppler rate (the
    port's scenario halves the delay's second derivative); after the 2 s
    of lead symbols, the same I/NAV pages."""
    sig = skymod.signal_of(GAL)
    traffic = dict(GAL_TRAFFIC, sky=dict(GAL_TRAFFIC["sky"],
                                         start_span_2s=0,
                                         clock_bias_max_s=0.0))
    sky = GAL_SIGNAL.sky(sig, traffic, seed=3)
    psats, pprns, precv, pephs = pscen.galileo_constellation(
        _port_signal(GAL), 8, traffic["recording_ms"] * 1e-3 + 1.0,
        cn0_dbhz=47.0)
    assert sky.prns == pprns and sky.absent == [1, 2]
    np.testing.assert_array_equal(sky.recv_ecef, precv)
    for a, b in zip(sky.sats, psats):
        assert (a.prn, a.doppler_hz, a.doppler_rate, a.code_phase_chips) == \
            (b.prn, b.doppler_hz, 2 * b.doppler_rate, b.code_phase_chips)
        np.testing.assert_array_equal(a.nav_bits[500:], b.nav_bits[500:])
        want = GAL_SIGNAL.broadcast(sky.ephs[a.prn])
        assert want == {k: getattr(pephs[a.prn], k) for k in want}


#: sha256 of each cell's sky (every Sat field, its nav_bits, the PRNs in
#: the sky and absent) at two seeds, and of the first 200 ms (GPS) and
#: 50 ms (L3OC) of its recording at seed 3 on the CPU in one thread (the
#: last bits of a multi-threaded sin or cos depend on where the threads'
#: chunks end), as the harness made them before each signal became a
#: module of its own (signals/).
PINS = {
    ("gps_l1ca_12ch", "hostfed_44s"): (
        {3: "35124b6ee57261fb48d9612a7b4c56a7957ca5f314e81e901a4ec064cbaffbeb",
         2 ** 31 + 11:
         "4c74bb944439ed2350f5ae0c2a3f064a5423d0b225722523b1e296d8a1d21854"},
        200,
        "e7367472054ed700d870f954988a629cec38a0651814cdaff322df259a87ebcd"),
    ("glonass_l3oc_12ch", "hostfed_9s"): (
        {3: "547ece5da65a134353fd13b7d7919d9004dbf0729100bb505a1dbd70b786ff1a",
         2 ** 31 + 11:
         "52ca4604d4698bab0d93c7ccfe794c109532d2362c235c755915075320321984"},
        50,
        "8068f5ab13ea4e3d30327a6e6595788cbebcbc24a4948bc54e08a41988b1b18f"),
}
SAT_FIELDS = ("prn", "doppler_hz", "doppler_rate", "if_offset_hz",
              "code_phase_chips", "carrier_phase", "cn0_dbhz")


def sky_digest(sky) -> str:
    h = hashlib.sha256()
    for s in sky.sats:
        h.update(np.array([getattr(s, k) for k in SAT_FIELDS], np.float64)
                 .tobytes())
        h.update(np.asarray(s.nav_bits, np.float64).tobytes())
    h.update(np.array(sky.prns + sky.absent, np.int64).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("cell", sorted(PINS))
def test_the_cells_skies_and_recordings_are_pinned(cell):
    skies, n_ms, recording = PINS[cell]
    cfg = plan.load_json(plan.HERE / "configs" / f"{cell[0]}.json")
    traffic = plan.load_json(plan.HERE / "traffic" / f"{cell[1]}.json")
    for seed, digest in skies.items():
        assert sky_digest(skymod.make_sky(cfg, traffic, seed)) == digest
    sky = skymod.make_sky(cfg, traffic, 3)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rec = ifsim.recording(sky, n_ms, 3, "cpu")
    finally:
        torch.set_num_threads(threads)
    assert hashlib.sha256(rec.numpy().tobytes()).hexdigest() == recording
