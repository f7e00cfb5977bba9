"""Klobuchar single-frequency ionospheric correction (ICD-GPS-200
20.3.3.5.2.5).

The reference decodes the broadcast alpha/beta page but never applies
it (objects/ephemeris.cpp:314 decode-only); this module closes the loop:
nav.pvt.navigate(iono=IonoUtc) corrects each epoch's pseudoranges with
the broadcast model before the final solve, and the live navigator
threads the decoded page in (NavConfig.use_iono).

Copied from gnsstpu/nav/iono.py; only the import prefix differs.
"""

from __future__ import annotations

import numpy as np


def klobuchar_delay(iu, lat_deg: float, lon_deg: float,
                    az_deg: np.ndarray, el_deg: np.ndarray,
                    t_gps_s: float) -> np.ndarray:
    """Per-satellite L1 ionospheric group delay [s].

    iu: decoded broadcast page (nav.almanac.IonoUtc: alpha0..3,
    beta0..3). Angles in degrees; t_gps_s is GPS system time (seconds,
    any week ambiguity folds out mod 86400). Vectorized over
    satellites. Algorithm exactly as ICD-GPS-200 (semicircle units,
    cubic AMP/PER fits, slant factor F, cosine day curve, 5 ns night
    floor).
    """
    el = np.maximum(np.asarray(el_deg, np.float64), 0.0) / 180.0
    az = np.radians(np.asarray(az_deg, np.float64))
    lat_sc = lat_deg / 180.0
    lon_sc = lon_deg / 180.0

    psi = 0.0137 / (el + 0.11) - 0.022
    phi_i = np.clip(lat_sc + psi * np.cos(az), -0.416, 0.416)
    lam_i = lon_sc + psi * np.sin(az) / np.cos(phi_i * np.pi)
    phi_m = phi_i + 0.064 * np.cos((lam_i - 1.617) * np.pi)

    t = np.mod(43200.0 * lam_i + t_gps_s, 86400.0)
    F = 1.0 + 16.0 * (0.53 - el) ** 3
    amp = (iu.alpha0 + phi_m * (iu.alpha1 + phi_m * (
        iu.alpha2 + phi_m * iu.alpha3)))
    amp = np.maximum(amp, 0.0)
    per = (iu.beta0 + phi_m * (iu.beta1 + phi_m * (
        iu.beta2 + phi_m * iu.beta3)))
    per = np.maximum(per, 72000.0)
    x = 2.0 * np.pi * (t - 50400.0) / per
    day = F * (5e-9 + amp * (1.0 - x * x / 2.0 + x ** 4 / 24.0))
    night = F * 5e-9
    return np.where(np.abs(x) < 1.57, day, night)
