"""Geodetic/topocentric coordinate utilities + troposphere model.

Reference semantics: GPS/L1/geoFunctions/{togeod,topocent,tropo,e_r_corr,
cart2geo,cart2utm,findUtmZone}.sci (Kai Borre lineage). Host-side float64
NumPy, vectorized over satellites where it matters (topocent/tropo are
called per satellite per LSQ iteration in the reference; here one call
handles all satellites).

Copied from gnsstpu/nav/geodesy.py; only the import prefix differs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

OMEGA_E = 7.292115147e-5    # value used by e_r_corr.sci
WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563


def e_r_corr(travel_time, pos):
    """Rotate ECEF satellite positions by Earth rotation during transit
    (Sagnac correction; e_r_corr.sci).

    travel_time: [S] seconds; pos: [S, 3]. Returns [S, 3].
    """
    w = OMEGA_E * np.asarray(travel_time, np.float64)
    c, s = np.cos(w), np.sin(w)
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    return np.stack([c * x + s * y, -s * x + c * y, z], axis=-1)


def togeod(x, y, z, a: float = WGS84_A, finv: float = 298.257223563
           ) -> Tuple[float, float, float]:
    """ECEF -> geodetic (lat deg, lon deg, height m), iterative (togeod.sci)."""
    f = 1.0 / finv if finv != 0 else 0.0
    esq = 2 * f - f * f
    lon = np.degrees(np.arctan2(y, x))
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1 - esq))
    h = 0.0
    for _ in range(50):
        sin_lat = np.sin(lat)
        N = a / np.sqrt(1 - esq * sin_lat ** 2)
        h_new = p / np.cos(lat) - N
        lat = np.arctan2(z, p * (1 - esq * N / (N + h_new)))
        if abs(h_new - h) < 1e-9:
            h = h_new
            break
        h = h_new
    return float(np.degrees(lat)), float(lon), float(h)


def topocent(recv_pos, dx) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Azimuth/elevation [deg] + range [m] of dx seen from recv_pos.

    topocent.sci semantics (ENU via the geodetic normal at recv_pos).
    recv_pos: [3]; dx: [S, 3]. Returns (az [S], el [S], dist [S]).
    """
    dx = np.atleast_2d(np.asarray(dx, np.float64))
    lat, lon, _ = togeod(*np.asarray(recv_pos, np.float64))
    lam, phi = np.radians(lon), np.radians(lat)
    cl, sl = np.cos(lam), np.sin(lam)
    cb, sb = np.cos(phi), np.sin(phi)
    e = -sl * dx[:, 0] + cl * dx[:, 1]
    n = -sb * cl * dx[:, 0] - sb * sl * dx[:, 1] + cb * dx[:, 2]
    u = cb * cl * dx[:, 0] + cb * sl * dx[:, 1] + sb * dx[:, 2]
    hor = np.hypot(e, n)
    az = np.where(hor < 1e-20, 0.0, np.degrees(np.arctan2(e, n)))
    az = np.where(az < 0, az + 360.0, az)
    el = np.where(hor < 1e-20, 90.0, np.degrees(np.arctan2(u, hor)))
    return az, el, np.linalg.norm(dx, axis=-1)


def tropo(sinel, hsta_km=0.0, p_mb=1013.0, t_kel=293.0, hum=50.0,
          hp_km=0.0, htkel_km=0.0, hhum_km=0.0) -> np.ndarray:
    """Goad & Goodman (1974) tropospheric delay [m] (tropo.sci:1-90).

    sinel may be a vector. Defaults match the leastSquarePos.sci call site
    (sea level, 1013 mb, 293 K, 50% humidity).
    """
    sinel = np.maximum(np.asarray(sinel, np.float64), 0.0)
    a_e = 6378.137
    b0 = 7.839257e-5
    tlapse = -6.5
    tkhum = t_kel + tlapse * (hhum_km - htkel_km)
    atkel = 7.5 * (tkhum - 273.15) / (237.3 + tkhum - 273.15)
    e0 = 0.0611 * hum * 10.0 ** atkel
    tksea = t_kel - tlapse * htkel_km
    em = -978.77 / (2.8704e6 * tlapse * 1.0e-5)
    tkelh = tksea + tlapse * hhum_km
    e0sea = e0 * (tksea / tkelh) ** (4 * em)
    tkelp = tksea + tlapse * hp_km
    psea = p_mb * (tksea / tkelp) ** em

    total = np.zeros_like(sinel)
    # Two passes: dry component, then wet (same quartic-profile integral).
    refsea_d = 77.624e-6 / tksea
    htop_d = 1.1385e-5 / refsea_d
    ref_d = refsea_d * psea * ((htop_d - hsta_km) / htop_d) ** 4
    refsea_w = (371900.0e-6 / tksea - 12.92e-6) / tksea
    htop_w = 1.1385e-5 * (1255.0 / tksea + 0.05) / refsea_w
    ref_w = refsea_w * e0sea * ((htop_w - hsta_km) / htop_w) ** 4

    for htop, ref in ((htop_d, ref_d), (htop_w, ref_w)):
        rtop = (a_e + htop) ** 2 - (a_e + hsta_km) ** 2 * (1 - sinel ** 2)
        rtop = np.sqrt(np.maximum(rtop, 0.0)) - (a_e + hsta_km) * sinel
        a = -sinel / (htop - hsta_km)
        b = -b0 * (1 - sinel ** 2) / (htop - hsta_km)
        alpha = np.stack([
            2 * a,
            2 * a ** 2 + 4 * b / 3,
            a * (a ** 2 + 3 * b),
            a ** 4 / 5 + 2.4 * a ** 2 * b + 1.2 * b ** 2,
            2 * a * b * (a ** 2 + 3 * b) / 3,
            b ** 2 * (6 * a ** 2 + 4 * b) * 1.428571e-1,
            np.where(b ** 2 > 1e-35, a * b ** 3 / 2, 0.0),
            np.where(b ** 2 > 1e-35, b ** 4 / 9, 0.0),
        ])
        dr = rtop.copy()
        for i in range(8):
            dr = dr + alpha[i] * rtop ** (i + 2)
        total = total + dr * ref * 1000.0
    return total


def cart2geo(x, y, z, ref_ellipsoid: int = 5
             ) -> Tuple[float, float, float]:
    """ECEF -> (lat deg, lon deg, h m) on ellipsoid 1..5 (cart2geo.sci);
    5 = WGS-84."""
    a_tab = [6378388.0, 6378160.0, 6378135.0, 6378137.0, 6378137.0]
    f_tab = [1 / 297.0, 1 / 298.247, 1 / 298.26, 1 / 298.257222101,
             1 / 298.257223563]
    a, f = a_tab[ref_ellipsoid - 1], f_tab[ref_ellipsoid - 1]
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


def find_utm_zone(lat_deg: float, lon_deg: float) -> int:
    """UTM zone number from lat/lon in degrees (findUtmZone.sci)."""
    if not (-80.0 <= lat_deg <= 84.0 and -180.0 <= lon_deg <= 180.0):
        raise ValueError("outside UTM coverage")
    return int((lon_deg + 180.0) // 6) + 1


def cart2utm(x, y, z, zone: int) -> Tuple[float, float, float]:
    """ECEF -> UTM (E, N, U) [m] in the given zone, WGS-84.

    Same role as cart2utm.sci (which goes via a Danish GI transformation);
    implemented with the standard Kruger series instead, which agrees to
    sub-mm for UTM's 0.9996 scale.
    """
    lat, lon, h = cart2geo(x, y, z, 5)
    phi = np.radians(lat)
    lam = np.radians(lon - (zone * 6 - 183))
    a, f = WGS84_A, WGS84_F
    e2 = f * (2 - f)
    ep2 = e2 / (1 - e2)
    N = a / np.sqrt(1 - e2 * np.sin(phi) ** 2)
    T = np.tan(phi) ** 2
    C = ep2 * np.cos(phi) ** 2
    A = lam * np.cos(phi)
    # Meridian arc length.
    M = a * ((1 - e2 / 4 - 3 * e2 ** 2 / 64 - 5 * e2 ** 3 / 256) * phi
             - (3 * e2 / 8 + 3 * e2 ** 2 / 32 + 45 * e2 ** 3 / 1024)
             * np.sin(2 * phi)
             + (15 * e2 ** 2 / 256 + 45 * e2 ** 3 / 1024) * np.sin(4 * phi)
             - (35 * e2 ** 3 / 3072) * np.sin(6 * phi))
    k0 = 0.9996
    E = k0 * N * (A + (1 - T + C) * A ** 3 / 6
                  + (5 - 18 * T + T ** 2 + 72 * C - 58 * ep2)
                  * A ** 5 / 120) + 500000.0
    Nn = k0 * (M + N * np.tan(phi) * (
        A ** 2 / 2 + (5 - T + 9 * C + 4 * C ** 2) * A ** 4 / 24
        + (61 - 58 * T + T ** 2 + 600 * C - 330 * ep2) * A ** 6 / 720))
    if lat < 0:
        Nn += 10000000.0
    return float(E), float(Nn), float(h)
