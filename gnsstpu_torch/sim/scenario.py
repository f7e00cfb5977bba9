"""Geometry-consistent GPS simulation scenarios (port of the GPS part of
gnsstpu/sim/scenario.py, numpy, copied because that module imports the
JAX simulator for SatParams).

build_scenario() turns broadcast ephemerides and a receiver position into
IFSimulator SatParams (delay, Doppler, Doppler rate, LNAV bits), so the
stream is consistent end to end: acquisition -> tracking -> LNAV decode ->
pseudoranges -> least squares must recover the configured position.
bench_constellation() is the geometry-true GPS sky the live-receiver
benchmark uses (bench.py::_bench_constellation).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from gnsstpu.config import SPEED_OF_LIGHT, SignalConfig
from gnsstpu.nav import geodesy, lnav
from gnsstpu.nav.orbits import satpos
from gnsstpu.nav.types import Ephemeris
from gnsstpu.signals.registry import get_signal
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
        t_r0 = tow0 - lead_s
        tau0 = signal_delay(eph, recv_ecef, t_r0)
        tau1 = signal_delay(eph, recv_ecef, t_r0 + T / 2)
        tau2 = signal_delay(eph, recv_ecef, t_r0 + T)
        taud = (4 * tau1 - 3 * tau0 - tau2) / T
        taudd = 2 * (tau2 - 2 * tau1 + tau0) / (T * T)
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
