"""Broadcast Keplerian orbits and the geodesy the skies need: a frozen
copy (NumPy, float64) of the port's nav/types.py Ephemeris, nav/orbits.py
satpos and nav/geodesy.py e_r_corr / togeod / topocent / cart2geo, with
the delay fit every geometry-true sky takes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SPEED_OF_LIGHT = 299792458.0
GM = 3.986005e14              # WGS-84 mu [m^3/s^2]
OMEGA_E_ORBIT = 7.2921151467e-5
OMEGA_E_SAGNAC = 7.292115147e-5
F_REL = -4.442807633e-10
HALF_WEEK = 302400.0
WGS84_A = 6378137.0


@dataclasses.dataclass
class Ephemeris:
    """GPS LNAV broadcast ephemeris (IS-GPS-200 fields)."""

    week: int = 0
    accuracy: int = 0
    health: int = 0
    T_GD: float = 0.0
    IODC: int = 0
    t_oc: float = 0.0
    a_f2: float = 0.0
    a_f1: float = 0.0
    a_f0: float = 0.0
    IODE_sf2: int = 0
    C_rs: float = 0.0
    deltan: float = 0.0
    M_0: float = 0.0
    C_uc: float = 0.0
    e: float = 0.0
    C_us: float = 0.0
    sqrtA: float = 0.0
    t_oe: float = 0.0
    C_ic: float = 0.0
    omega_0: float = 0.0
    C_is: float = 0.0
    i_0: float = 0.0
    C_rc: float = 0.0
    omega: float = 0.0
    omegaDot: float = 0.0
    IODE_sf3: int = 0
    iDot: float = 0.0
    valid: bool = False


def check_t(t):
    t = np.asarray(t, np.float64)
    t = np.where(t > HALF_WEEK, t - 2 * HALF_WEEK, t)
    return np.where(t < -HALF_WEEK, t + 2 * HALF_WEEK, t)


def satpos(transmit_time, ephs, gm: float = GM,
           omega_e: float = OMEGA_E_ORBIT):
    """(ECEF positions [S, 3] m, clock corrections [S] s) at transmit
    times, with the relativistic term and -T_GD in the clock; gm and
    omega_e are the constellation's (default GPS's WGS-84)."""
    S = len(ephs)
    tt = np.broadcast_to(np.asarray(transmit_time, np.float64), (S,))

    def f(name):
        return np.array([getattr(e, name) for e in ephs], np.float64)

    dt = check_t(tt - f("t_oc"))
    clk = (f("a_f2") * dt + f("a_f1")) * dt + f("a_f0") - f("T_GD")
    time = tt - clk
    sqrtA, ecc = f("sqrtA"), f("e")
    a = sqrtA * sqrtA
    tk = check_t(time - f("t_oe"))
    M = f("M_0") + (np.sqrt(gm / a ** 3) + f("deltan")) * tk
    E = M.copy()
    for _ in range(20):
        E = M + ecc * np.sin(E)
    dtr = F_REL * ecc * sqrtA * np.sin(E)
    nu = np.arctan2(np.sqrt(1.0 - ecc ** 2) * np.sin(E), np.cos(E) - ecc)
    phi = nu + f("omega")
    c2, s2 = np.cos(2 * phi), np.sin(2 * phi)
    u = phi + f("C_uc") * c2 + f("C_us") * s2
    r = a * (1.0 - ecc * np.cos(E)) + f("C_rc") * c2 + f("C_rs") * s2
    inc = f("i_0") + f("iDot") * tk + f("C_ic") * c2 + f("C_is") * s2
    Om = (f("omega_0") + (f("omegaDot") - omega_e) * tk
          - omega_e * f("t_oe"))
    xp, yp = r * np.cos(u), r * np.sin(u)
    pos = np.stack([xp * np.cos(Om) - yp * np.cos(inc) * np.sin(Om),
                    xp * np.sin(Om) + yp * np.cos(inc) * np.cos(Om),
                    yp * np.sin(inc)], axis=-1)
    return pos, clk + dtr


def e_r_corr(travel_time, pos):
    """ECEF positions rotated by the Earth's turn during the transit."""
    w = OMEGA_E_SAGNAC * np.asarray(travel_time, np.float64)
    c, s = np.cos(w), np.sin(w)
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    return np.stack([c * x + s * y, -s * x + c * y, z], axis=-1)


def togeod(x, y, z, a: float = WGS84_A, finv: float = 298.257223563):
    f = 1.0 / finv
    esq = 2 * f - f * f
    lon = np.degrees(np.arctan2(y, x))
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1 - esq))
    h = 0.0
    for _ in range(50):
        N = a / np.sqrt(1 - esq * np.sin(lat) ** 2)
        h_new = p / np.cos(lat) - N
        lat = np.arctan2(z, p * (1 - esq * N / (N + h_new)))
        if abs(h_new - h) < 1e-9:
            h = h_new
            break
        h = h_new
    return float(np.degrees(lat)), float(lon), float(h)


def topocent(recv_pos, dx):
    """(azimuth deg, elevation deg, range m) of dx [S, 3] from recv_pos."""
    dx = np.atleast_2d(np.asarray(dx, np.float64))
    lat, lon, _ = togeod(*np.asarray(recv_pos, np.float64))
    lam, phi = np.radians(lon), np.radians(lat)
    cl, sl, cb, sb = np.cos(lam), np.sin(lam), np.cos(phi), np.sin(phi)
    e = -sl * dx[:, 0] + cl * dx[:, 1]
    n = -sb * cl * dx[:, 0] - sb * sl * dx[:, 1] + cb * dx[:, 2]
    u = cb * cl * dx[:, 0] + cb * sl * dx[:, 1] + sb * dx[:, 2]
    hor = np.hypot(e, n)
    az = np.where(hor < 1e-20, 0.0, np.degrees(np.arctan2(e, n)))
    az = np.where(az < 0, az + 360.0, az)
    el = np.where(hor < 1e-20, 90.0, np.degrees(np.arctan2(u, hor)))
    return az, el, np.linalg.norm(dx, axis=-1)


def cart2geo(x, y, z):
    """ECEF -> (lat deg, lon deg, h m) on WGS-84."""
    a, f = 6378137.0, 1 / 298.257223563
    lam = np.arctan2(y, x)
    ex2 = (2 - f) * f / (1 - f) ** 2
    c = a * np.sqrt(1 + ex2)
    p = np.hypot(x, y)
    phi = np.arctan(z / (p * (1 - (2 - f) * f)))
    h, oldh = 0.1, 0.0
    for _ in range(100):
        if abs(h - oldh) <= 1e-12:
            break
        oldh = h
        N = c / np.sqrt(1 + ex2 * np.cos(phi) ** 2)
        phi = np.arctan(z / (p * (1 - (2 - f) * f * N / (N + h))))
        h = p / np.cos(phi) - N
    return float(np.degrees(phi)), float(np.degrees(lam)), float(h)


def signal_delay(eph: Ephemeris, recv_ecef, t_receive: float,
                 **orbit) -> float:
    """Geometric delay [s] of reception at true time t_receive (fixed
    point in the emission time, with the Earth's turn); orbit: satpos's
    gm and omega_e."""
    tau = 0.075
    for _ in range(12):
        pos, _ = satpos(t_receive - tau, [eph], **orbit)
        rot = e_r_corr(np.array([tau]), pos)[0]
        tau = float(np.linalg.norm(rot - recv_ecef) / SPEED_OF_LIGHT)
    return tau


def fit_delay(eph, recv, t_r0: float, T: float, **orbit) -> tuple:
    """(tau0, first, second derivative) of the quadratic through the
    geometric delay at t_r0, t_r0 + T/2 and t_r0 + T. The IF simulator
    integrates the Doppler rate as the second derivative (pi fd_rate t^2
    in the carrier), so it takes 4 (tau2 - 2 tau1 + tau0) / T^2, not
    half of it: half leaves the code delay up to ~50 m off the geometry
    at the end of a 45 s recording, and the fixes ~100 m off."""
    tau0 = signal_delay(eph, recv, t_r0, **orbit)
    tau1 = signal_delay(eph, recv, t_r0 + T / 2, **orbit)
    tau2 = signal_delay(eph, recv, t_r0 + T, **orbit)
    return (tau0, (4 * tau1 - 3 * tau0 - tau2) / T,
            4 * (tau2 - 2 * tau1 + tau0) / (T * T))
