"""Broadcast-ephemeris satellite positions (GPS Kepler orbit model).

Reference semantics: GPS/L1/geoFunctions/satpos.sci:1-149 (Kepler elements
+ harmonic corrections + Earth-rotation-referenced node, relativistic and
T_GD clock terms) and check_t.sci (half-week wrap). Vectorized over
satellites in float64 NumPy — this is host-side nav math (SURVEY.md L5),
not device compute.

The GLONASS PZ-90 RK4 integrator (satposg.sci) lives in glonass_orbits.py.

Copied from gnsstpu/nav/orbits.py; only the import prefix differs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from gnsstpu_torch.nav.types import Ephemeris

OMEGA_E = 7.2921151467e-5     # Earth rotation rate [rad/s] (WGS-84)
GM = 3.986005e14              # WGS-84 mu [m^3/s^2]
F_REL = -4.442807633e-10      # relativistic clock constant [s/sqrt(m)]
HALF_WEEK = 302400.0


def check_t(t):
    """Half-week rollover correction (check_t.sci)."""
    t = np.asarray(t, np.float64)
    t = np.where(t > HALF_WEEK, t - 2 * HALF_WEEK, t)
    return np.where(t < -HALF_WEEK, t + 2 * HALF_WEEK, t)


def satpos(transmit_time, ephs: Sequence[Ephemeris],
           gm: float = GM, omega_e: float = OMEGA_E
           ) -> Tuple[np.ndarray, np.ndarray]:
    """ECEF satellite positions + clock corrections at transmit times.

    Args:
      transmit_time: scalar or [S] GPS time of week [s] at transmission.
      ephs: one Ephemeris per satellite.
      gm / omega_e: gravitational parameter and Earth rotation rate —
        default WGS-84/GPS; BeiDou (CGCS2000) and Galileo (GTRF) pass
        their ICD constants.

    Returns:
      (pos [S, 3] ECEF meters, clk [S] seconds). The clock correction
      includes the relativistic term and -T_GD (satpos.sci:143-146).
    """
    S = len(ephs)
    tt = np.broadcast_to(np.asarray(transmit_time, np.float64), (S,))

    def f(name):
        return np.array([getattr(e, name) for e in ephs], np.float64)

    t_oc, a_f0, a_f1, a_f2, t_gd = (f("t_oc"), f("a_f0"), f("a_f1"),
                                    f("a_f2"), f("T_GD"))
    sqrtA, ecc, M_0, deltan = f("sqrtA"), f("e"), f("M_0"), f("deltan")
    omega, omega_0, omegaDot = f("omega"), f("omega_0"), f("omegaDot")
    i_0, iDot, t_oe = f("i_0"), f("iDot"), f("t_oe")
    C_uc, C_us, C_rc, C_rs, C_ic, C_is = (f("C_uc"), f("C_us"), f("C_rc"),
                                          f("C_rs"), f("C_ic"), f("C_is"))

    dt = check_t(tt - t_oc)
    clk = (a_f2 * dt + a_f1) * dt + a_f0 - t_gd
    time = tt - clk

    a = sqrtA * sqrtA
    tk = check_t(time - t_oe)
    n = np.sqrt(gm / a ** 3) + deltan
    M = M_0 + n * tk

    # Kepler's equation, fixed-point iteration (satpos.sci does 10 rounds
    # with an early exit at 1e-12; 20 unconditional rounds dominate that).
    E = M.copy()
    for _ in range(20):
        E = M + ecc * np.sin(E)

    dtr = F_REL * ecc * sqrtA * np.sin(E)
    nu = np.arctan2(np.sqrt(1.0 - ecc ** 2) * np.sin(E), np.cos(E) - ecc)
    phi = nu + omega

    u = phi + C_uc * np.cos(2 * phi) + C_us * np.sin(2 * phi)
    r = a * (1.0 - ecc * np.cos(E)) + C_rc * np.cos(2 * phi) \
        + C_rs * np.sin(2 * phi)
    inc = i_0 + iDot * tk + C_ic * np.cos(2 * phi) + C_is * np.sin(2 * phi)

    Om = omega_0 + (omegaDot - omega_e) * tk - omega_e * t_oe

    xp = r * np.cos(u)
    yp = r * np.sin(u)
    pos = np.stack([
        xp * np.cos(Om) - yp * np.cos(inc) * np.sin(Om),
        xp * np.sin(Om) + yp * np.cos(inc) * np.cos(Om),
        yp * np.sin(inc),
    ], axis=-1)

    clk = clk + dtr
    return pos, clk


def central_diff_vel(satpos_fn, transmit_time, ephs, dt: float = 0.5):
    """(pos [S,3], vel [S,3], clk [S]): ECEF velocity by central
    difference of any satpos-style propagator (adequate to ~1e-4 m/s).
    Shared by the GPS/Galileo/BeiDou velocity adapters."""
    p0, clk = satpos_fn(transmit_time, ephs)
    pm, _ = satpos_fn(transmit_time - dt, ephs)
    pp, _ = satpos_fn(transmit_time + dt, ephs)
    return p0, (pp - pm) / (2.0 * dt), clk
