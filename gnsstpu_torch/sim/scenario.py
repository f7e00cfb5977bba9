"""Geometry-consistent GPS, GLONASS, BeiDou and Galileo simulation
scenarios (port of gnsstpu/sim/scenario.py, numpy, copied because that
module imports the JAX simulator for SatParams).

build_scenario() / build_scenario_glonass() / build_scenario_beidou() /
build_scenario_galileo() turn broadcast ephemerides and a receiver position
into IFSimulator SatParams (delay, Doppler, Doppler rate, FDMA offset, LNAV
bits / GLONASS strings / D1 / I/NAV symbols), so the stream is consistent
end to end: acquisition -> tracking -> nav decode -> pseudoranges -> least
squares must recover the configured position. bench_constellation() is the
geometry-true GPS sky the live-receiver benchmark uses
(bench.py::_bench_constellation); make_glonass_constellation() is the
reference's GLONASS sky; beidou_constellation() and
galileo_constellation() are the BeiDou and Galileo skies of the
reference's tests (tests/test_beidou.py::make_bd_constellation,
tests/test_galileo.py::make_gal_constellation).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from gnsstpu_torch.config import SPEED_OF_LIGHT, SignalConfig
from gnsstpu_torch.nav import geodesy, lnav
from gnsstpu_torch.nav.orbits import satpos
from gnsstpu_torch.nav.types import Ephemeris
from gnsstpu_torch.signals.registry import get_signal
from gnsstpu_torch.sim.generator import SatParams


def signal_delay(eph: Ephemeris, recv_ecef: np.ndarray, t_receive: float,
                 satpos_fn=satpos) -> float:
    """Geometric signal delay tau [s] for reception at true time
    t_receive (fixed point in emission time with Sagnac rotation)."""
    tau = 0.075
    for _ in range(12):
        pos, _ = satpos_fn(t_receive - tau, [eph])
        rot = geodesy.e_r_corr(np.array([tau]), pos)[0]
        tau = float(np.linalg.norm(rot - recv_ecef) / SPEED_OF_LIGHT)
    return tau


def _fit_delay(eph, recv_ecef, t_r0, T, satpos_fn):
    """(tau0, taud, taudd): quadratic delay fit over the run."""
    tau0 = signal_delay(eph, recv_ecef, t_r0, satpos_fn)
    tau1 = signal_delay(eph, recv_ecef, t_r0 + T / 2, satpos_fn)
    tau2 = signal_delay(eph, recv_ecef, t_r0 + T, satpos_fn)
    taud = (4 * tau1 - 3 * tau0 - tau2) / T
    taudd = 2 * (tau2 - 2 * tau1 + tau0) / (T * T)
    return tau0, taud, taudd


def build_scenario(sig: SignalConfig, ephs: Dict[int, Ephemeris],
                   recv_ecef: np.ndarray, tow0_6s: int,
                   duration_s: float, lead_s: float = 2.0,
                   cn0_dbhz: float = 47.0,
                   n_subframes: int = 10) -> List[SatParams]:
    """SatParams for each PRN in ephs, geometry-consistent.

    tow0_6s: truncated TOW (6 s units) of the first encoded subframe.
    lead_s: filler-bit seconds before the first subframe (a whole number
    of bit periods).
    """
    sd = get_signal(sig.signal)
    bit_s = sd.bit_len_codes * sig.code_period_s
    n_lead = int(round(lead_s / bit_s))
    if abs(n_lead * bit_s - lead_s) > 1e-9:
        raise ValueError("lead_s must be a whole number of bit periods")
    tow0 = tow0_6s * 6.0
    rng = np.random.default_rng(tow0_6s)
    sats = []
    T = duration_s
    for prn, eph in sorted(ephs.items()):
        _, clk = satpos(tow0, [eph])
        clk = float(clk[0])
        tau0, taud, taudd = _fit_delay(eph, recv_ecef, tow0 - lead_s, T,
                                       satpos)
        f_carr = sd.carrier_freq(prn)
        filler = rng.choice([-1.0, 1.0], size=n_lead)
        filler[-2:] = 1.0
        bits = np.concatenate([
            filler,
            lnav.encode_frames(eph, tow0=tow0_6s, n_subframes=n_subframes)])
        sats.append(SatParams(
            prn=prn,
            doppler_hz=-f_carr * taud,
            doppler_rate=-f_carr * taudd,
            code_phase_chips=(tau0 - clk) * sig.code_freq,
            carrier_phase=float(rng.uniform(0, 2 * np.pi)),
            cn0_dbhz=cn0_dbhz,
            nav_bits=bits,
        ))
    return sats


#: True receiver position of bench_constellation [ECEF m].
BENCH_RECV_ECEF = np.array([3427947.0, 603774.0, 5326967.0])


def bench_constellation(sig: SignalConfig, n_sats: int, duration_s: float):
    """Geometry-true GPS constellation with LNAV bit streams (the
    bench.py live-receiver sky): 24 synthetic Keplerian orbits, the
    n_sats highest in elevation. Returns (sats, prns, recv_ecef)."""
    base = dict(
        t_oc=266400.0, a_f0=2.45e-4, a_f1=-3.2e-12, a_f2=0.0,
        T_GD=-4.656e-9, sqrtA=5153.712, e=0.0123456, M_0=1.23456,
        deltan=4.2e-9, omega=-1.87654, omega_0=-2.0312,
        omegaDot=-8.1e-9, i_0=0.96123, iDot=4.0e-10, t_oe=266400.0,
        C_uc=-6.7e-7, C_us=8.1e-6, C_rc=221.5625, C_rs=-12.8125,
        C_ic=-7.45e-8, C_is=1.12e-7, valid=True)
    recv = BENCH_RECV_ECEF.copy()
    tow0_6s = 44400                    # = t_oe (tk ~ 0)
    ephs = []
    for k in range(24):
        d = dict(base)
        d["M_0"] = (base["M_0"] + 2.1 * k) % (2 * np.pi) - np.pi
        d["omega_0"] = (base["omega_0"] + 1.1 * k) % (2 * np.pi) - np.pi
        d["i_0"] = 0.93 + 0.03 * (k % 3)
        ephs.append(Ephemeris(**d))
    pos, _ = satpos(tow0_6s * 6.0, ephs)
    _, el, _ = geodesy.topocent(recv, pos - recv)
    order = np.argsort(-el)[:n_sats]
    chosen = {int(k) + 1: ephs[k] for k in order}
    n_sf = int(np.ceil((duration_s + 8.0) / 6.0))
    sats = build_scenario(sig, chosen, recv, tow0_6s,
                          duration_s=duration_s, cn0_dbhz=47.0,
                          n_subframes=n_sf)
    return sats, sorted(chosen), recv


def position_error_m(lat_deg: float, lon_deg: float, h_m: float,
                     recv_ecef: np.ndarray) -> float:
    """3-D distance [m] of a geodetic fix from the true ECEF position
    (local north/east/up, as bench.py reports it)."""
    tlat, tlon, th = geodesy.cart2geo(*recv_ecef, 5)
    r_e = 6378137.0
    dn = np.deg2rad(lat_deg - tlat) * r_e
    de = np.deg2rad(lon_deg - tlon) * r_e * np.cos(np.deg2rad(lat_deg))
    du = h_m - th
    return float(np.sqrt(dn * dn + de * de + du * du))


def signal_delay_gl(eph, recv_ecef: np.ndarray, t_receive: float) -> float:
    """Geometric delay [s] for a GLONASS SV (PZ-90 RK4 forward model with
    Sagnac rotation; the GLONASS form of signal_delay)."""
    from gnsstpu_torch.nav.glonass import satposg

    tau = 0.075
    for _ in range(12):
        pos, _, _ = satposg(t_receive - tau, [eph])
        rot = geodesy.e_r_corr(np.array([tau]), pos)[0]
        tau = float(np.linalg.norm(rot - recv_ecef) / SPEED_OF_LIGHT)
    return tau


def build_scenario_glonass(sig: SignalConfig, gephs: Dict[int, "object"],
                           recv_ecef: np.ndarray, t0_day_s: float,
                           duration_s: float, lead_strings: int = 1,
                           cn0_dbhz: float = 47.0, n_strings: int = 6,
                           seed: int = 77
                           ) -> Tuple[List[SatParams], Dict[int, "object"]]:
    """Geometry-consistent GLONASS FDMA SatParams + quantized ephemerides
    (copied from the reference).

    gephs: {freq-channel prn: GlonassEphemeris} with state vectors at tb;
    tk fields are overwritten so string 1's data start is at satellite
    time-of-day t0_day_s (a multiple of 30 s, the tk grid). The stream
    carries `lead_strings` dummy strings (random data + the 0.3 s time
    mark) before string 1. The scenario is generated from the quantized
    ephemerides, so the decoded ephemeris is bit-exact truth.
    """
    import dataclasses as _dc

    from gnsstpu_torch.nav import glonass as gl

    sd = get_signal(sig.signal)
    if abs(t0_day_s % 30.0) > 1e-9:
        raise ValueError("t0_day_s must be a multiple of 30 s (tk grid)")
    lead_s = 2.0 * lead_strings
    rng = np.random.default_rng(seed)
    qephs: Dict[int, gl.GlonassEphemeris] = {}
    sats: List[SatParams] = []
    T = duration_s
    t_r0 = t0_day_s - lead_s
    tk = int(round(t0_day_s))
    for prn, eph0 in sorted(gephs.items()):
        eph = gl.quantize_eph(_dc.replace(
            eph0, tk_h=tk // 3600, tk_m=(tk % 3600) // 60, tk_s=tk % 60))
        qephs[prn] = eph
        _, _, clk = gl.satposg(t0_day_s, [eph])
        clk = float(clk[0])
        tau0 = signal_delay_gl(eph, recv_ecef, t_r0)
        tau1 = signal_delay_gl(eph, recv_ecef, t_r0 + T / 2)
        tau2 = signal_delay_gl(eph, recv_ecef, t_r0 + T)
        taud = (4 * tau1 - 3 * tau0 - tau2) / T
        taudd = 2 * (tau2 - 2 * tau1 + tau0) / (T * T)

        f_carr = sd.carrier_freq(prn)
        lead = []
        for _ in range(lead_strings):
            d = rng.choice([-1.0, 1.0], size=170)
            lead.append(np.concatenate([d, gl.TIME_MARK_PM1]))
        sym = np.concatenate(lead + [gl.encode_strings(eph, n_strings)])
        sats.append(SatParams(
            prn=prn,
            doppler_hz=-f_carr * taud,
            doppler_rate=-f_carr * taudd,
            if_offset_hz=f_carr - sd.carrier_freq(sd.fdma_zero_prn),
            code_phase_chips=(tau0 - clk) * sig.code_freq,
            carrier_phase=float(rng.uniform(0, 2 * np.pi)),
            cn0_dbhz=cn0_dbhz,
            nav_bits=sym,
        ))
    return sats, qephs


def build_scenario_beidou(sig: SignalConfig, ephs: Dict[int, "object"],
                          recv_ecef: np.ndarray, sow0: int,
                          duration_s: float, lead_s: float = 2.0,
                          cn0_dbhz: float = 47.0, n_subframes: int = 3,
                          seed: int = 41
                          ) -> Tuple[List[SatParams], Dict[int, "object"]]:
    """Geometry-consistent BeiDou B1I D1 SatParams + quantized ephs
    (copied from the reference).

    sow0: BDT seconds-of-week of the first encoded subframe start. The
    symbol stream is lead_s of random 1 ms symbols, then subframes
    1..n_subframes (bit x NH(20)). Ephemerides are quantized through the
    D1 codec so the decoded fields are truth.
    """
    from gnsstpu_torch.nav import beidou as bd

    sd = get_signal(sig.signal)
    rng = np.random.default_rng(seed)
    n_lead = int(round(lead_s / sig.code_period_s))
    qephs = {}
    sats: List[SatParams] = []
    t_r0 = sow0 - lead_s
    for prn, eph0 in sorted(ephs.items()):
        q, _ = bd.decode_subframes(
            bd.encode_symbols(eph0, 0, n_subframes=3) * 800.0, 0, 3)
        qephs[prn] = q
        _, clk = bd.satpos_bd(float(sow0), [q])
        clk = float(clk[0])
        tau0, taud, taudd = _fit_delay(q, recv_ecef, t_r0, duration_s,
                                       bd.satpos_bd)
        f_carr = sd.carrier_freq(prn)
        sym = np.concatenate([
            rng.choice([-1.0, 1.0], size=n_lead),
            bd.encode_symbols(q, sow0, n_subframes=n_subframes)])
        sats.append(SatParams(
            prn=prn,
            doppler_hz=-f_carr * taud,
            doppler_rate=-f_carr * taudd,
            code_phase_chips=(tau0 - clk) * sig.code_freq,
            carrier_phase=float(rng.uniform(0, 2 * np.pi)),
            cn0_dbhz=cn0_dbhz,
            nav_bits=sym,
        ))
    return sats, qephs


#: True receiver position and first subframe SOW of beidou_constellation.
BEIDOU_RECV_ECEF = np.array([3427947.0, 603774.0, 5326967.0])
BEIDOU_SOW0 = 123000                   # = t_oe (subframe grid: 6 s)


def beidou_constellation(sig: SignalConfig, n_sats=None,
                         duration_s: float = 20.6, cn0_dbhz: float = 48.0,
                         min_elev_deg: float = 15.0):
    """Geometry-true BeiDou B1I sky with D1 symbol streams: the reference
    tests' 30 synthetic CGCS2000 Keplerian orbits
    (tests/test_beidou.py::make_bdeph / make_bd_constellation), the n_sats
    highest in elevation (every satellite above min_elev_deg when n_sats
    is None; raises when fewer are above it), with subframes covering
    duration_s. Returns (sats, prns, recv_ecef, quantized ephemerides)."""
    from gnsstpu_torch.nav import beidou as bd

    base = bd.BeiDouEphemeris(
        SatH1=0, IODC=17, URAI=2, WN=810, t_oc=123000.0, T_GD_1=-2.5e-9,
        alpha0=1.2e-8, alpha1=-7.45e-9, alpha2=5.96e-8, alpha3=-1.19e-7,
        beta0=110592.0, beta1=-32768.0, beta2=131072.0, beta3=-196608.0,
        a0=-4.37e-4, a1=3.18e-12, a2=0.0, IODE=9,
        deltan=4.19e-9, C_uc=-5.82e-6, M_0=0.76543, e=0.00512345,
        C_us=7.23e-6, C_rc=187.3125, C_rs=-98.90625, sqrtA=5282.619,
        t_oe=123000.0, i_0=0.98765, C_ic=-4.66e-8, omegaDot=-6.8e-9,
        C_is=9.31e-8, iDot=2.9e-10, omega_0=1.40625, omega=-2.53125,
        valid=True)
    ephs = []
    for k in range(30):
        e = bd.BeiDouEphemeris(**{**base.__dict__})
        e.M_0 = (base.M_0 + 2.3 * k) % (2 * np.pi) - np.pi
        e.omega_0 = (base.omega_0 + 1.3 * k) % (2 * np.pi) - np.pi
        e.i_0 = 0.93 + 0.04 * (k % 3)
        ephs.append(e)
    recv = BEIDOU_RECV_ECEF.copy()
    pos, _ = bd.satpos_bd(float(BEIDOU_SOW0), ephs)
    _, el, _ = geodesy.topocent(recv, pos - recv)
    above = int(np.sum(el > min_elev_deg))
    n = above if n_sats is None else n_sats
    if n > above:
        raise ValueError(f"{n} satellites asked for, {above} above "
                         f"{min_elev_deg} deg")
    order = np.argsort(-el)[:n]
    chosen = {int(k) + 1: ephs[k] for k in order}
    n_sf = int(np.ceil(duration_s / 6.0)) + 1
    sats, qephs = build_scenario_beidou(
        sig, chosen, recv, BEIDOU_SOW0, duration_s=duration_s,
        cn0_dbhz=cn0_dbhz, n_subframes=n_sf)
    return sats, sorted(chosen), recv, qephs


def make_glonass_constellation(recv_ecef: np.ndarray, tb: int, n: int = 5,
                               seed: int = 3) -> Dict[int, "object"]:
    """Synthetic GLONASS constellation with healthy geometry (copied from
    the reference).

    State-vector ephemerides for n visible SVs on distinct frequency
    channels: satellites at GLONASS orbit radius along a chosen az/el
    spread (one near-zenith + a low-elevation ring), near-circular ECEF
    velocity (Earth-rotation corrected). tb is the ephemeris reference
    time in minutes of the Moscow day.
    """
    from gnsstpu_torch.nav.glonass import GlonassEphemeris

    mu = 398600.44e9
    we = 0.7292115e-4
    r_orb = 25500e3
    recv_ecef = np.asarray(recv_ecef, np.float64)
    lat, lon, _ = geodesy.cart2geo(*recv_ecef, 5)
    phi, lam = np.radians(lat), np.radians(lon)
    e_hat = np.array([-np.sin(lam), np.cos(lam), 0.0])
    n_hat = np.array([-np.sin(phi) * np.cos(lam),
                      -np.sin(phi) * np.sin(lam), np.cos(phi)])
    u_hat = np.array([np.cos(phi) * np.cos(lam),
                      np.cos(phi) * np.sin(lam), np.sin(phi)])
    rays = [(0.0, 80.0), (60.0, 20.0), (130.0, 25.0), (190.0, 18.0),
            (250.0, 30.0), (315.0, 22.0), (100.0, 55.0)][:n]
    rng = np.random.default_rng(seed)
    gephs = {}
    for k, (az_d, el_d) in enumerate(rays):
        az, el = np.radians(az_d), np.radians(el_d)
        u = (np.cos(el) * (np.sin(az) * e_hat + np.cos(az) * n_hat)
             + np.sin(el) * u_hat)
        d = recv_ecef @ u
        s = -d + np.sqrt(d * d + r_orb ** 2 - recv_ecef @ recv_ecef)
        p = recv_ecef + s * u
        h = np.cross(p, rng.normal(size=3))
        h /= np.linalg.norm(h)
        v_i = np.sqrt(mu / r_orb) * h
        v = v_i - np.cross(np.array([0.0, 0.0, we]), p)
        prn = 5 + k                       # freq channels -2..+4 around 0
        gephs[prn] = GlonassEphemeris(
            tb=tb, x=p[0] / 1e3, y=p[1] / 1e3, z=p[2] / 1e3,
            xdot=v[0] / 1e3, ydot=v[1] / 1e3, zdot=v[2] / 1e3,
            taun=float(rng.uniform(-1e-4, 1e-4)),
            gamman=float(rng.uniform(-2e-12, 2e-12)),
            n=prn, valid=True)
    return gephs


def build_scenario_galileo(sig: SignalConfig, ephs: Dict[int, "object"],
                           recv_ecef: np.ndarray, tow0: int,
                           duration_s: float, lead_s: float = 2.0,
                           cn0_dbhz: float = 47.0, n_pages: int = 5,
                           seed: int = 59
                           ) -> Tuple[List[SatParams], Dict[int, "object"]]:
    """Geometry-consistent Galileo E1B I/NAV SatParams + quantized ephs
    (copied from the reference).

    tow0: GST TOW of the first nominal page start. Symbols are 250 sps
    (one per 4 ms code period); lead_s of random symbols precede the
    pages (must be a multiple of the code period).
    """
    from gnsstpu_torch.nav import galileo as gal

    sd = get_signal(sig.signal)
    rng = np.random.default_rng(seed)
    n_lead = int(round(lead_s / sig.code_period_s))
    if abs(n_lead * sig.code_period_s - lead_s) > 1e-9:
        raise ValueError("lead_s must be a whole number of code periods")
    qephs = {}
    sats: List[SatParams] = []
    t_r0 = tow0 - lead_s
    for prn, eph0 in sorted(ephs.items()):
        q, _ = gal.decode_frames(
            gal.encode_frames(eph0, tow0=0, n_pages=5) * 800.0, 0)
        q.SVID = prn
        qephs[prn] = q
        _, clk = gal.satpos_gal(float(tow0), [q])
        clk = float(clk[0])
        tau0, taud, taudd = _fit_delay(q, recv_ecef, t_r0, duration_s,
                                       gal.satpos_gal)
        f_carr = sd.carrier_freq(prn)
        sym = np.concatenate([
            rng.choice([-1.0, 1.0], size=n_lead),
            gal.encode_frames(q, tow0=tow0, n_pages=n_pages)])
        sats.append(SatParams(
            prn=prn,
            doppler_hz=-f_carr * taud,
            doppler_rate=-f_carr * taudd,
            code_phase_chips=(tau0 - clk) * sig.code_freq,
            carrier_phase=float(rng.uniform(0, 2 * np.pi)),
            cn0_dbhz=cn0_dbhz,
            nav_bits=sym,
        ))
    return sats, qephs


#: True receiver position and first page TOW of galileo_constellation.
GALILEO_RECV_ECEF = np.array([3427947.0, 603774.0, 5326967.0])
GALILEO_TOW0 = 351000                  # = t_oe


def galileo_constellation(sig: SignalConfig, n_sats: int,
                          duration_s: float, cn0_dbhz: float = 48.0):
    """Geometry-true Galileo E1B sky with I/NAV symbol streams: the
    reference tests' 30 synthetic Keplerian orbits
    (tests/test_galileo.py::make_gal_constellation), the n_sats highest
    in elevation, with pages covering duration_s. Returns (sats, prns,
    recv_ecef, quantized ephemerides)."""
    from gnsstpu_torch.nav import galileo as gal

    base = gal.GalileoEphemeris(
        IODnav=61, t_oe=351000.0, M_0=0.654321, e=2.5e-4, sqrtA=5440.588,
        omega_0=-1.0471975, i_0=0.9773844, omega=0.5235988,
        iDot=-1.8e-10, omegaDot=-5.6e-9, deltan=3.2e-9,
        C_uc=-8.5e-7, C_us=9.9e-6, C_rc=112.25, C_rs=-27.125,
        SVID=11, C_ic=3.7e-8, C_is=-5.6e-8, t_oc=351000.0,
        a_f0=-1.2e-4, a_f1=-7.9e-12, a_f2=0.0,
        ai0=40.0, ai1=0.15, ai2=0.002, BGD_E1E5a=2.3e-9,
        BGD_E1E5b=2.8e-9, WN=1042, TOW=351000)
    ephs = []
    for k in range(30):
        e = gal.GalileoEphemeris(**{**base.__dict__})
        e.M_0 = (base.M_0 + 2.7 * k) % (2 * np.pi) - np.pi
        e.omega_0 = (base.omega_0 + 1.7 * k) % (2 * np.pi) - np.pi
        e.i_0 = 0.95 + 0.03 * (k % 3)
        ephs.append(e)
    recv = GALILEO_RECV_ECEF.copy()
    pos, _ = gal.satpos_gal(float(GALILEO_TOW0), ephs)
    _, el, _ = geodesy.topocent(recv, pos - recv)
    order = np.argsort(-el)[:n_sats]
    chosen = {int(k) + 1: ephs[k] for k in order}
    n_pages = int(np.ceil((duration_s + 2.0) / 2.0)) + 1
    sats, qephs = build_scenario_galileo(
        sig, chosen, recv, GALILEO_TOW0, duration_s=duration_s,
        cn0_dbhz=cn0_dbhz, n_pages=n_pages)
    return sats, sorted(chosen), recv, qephs
