"""Satellite visibility / Doppler prediction for warm-start acquisition.

The framework's SV_Select predictor: the reference computes almanac-based
satellite positions, elevations against a mask angle, and expected Doppler
to decide which SVs to acquire and where to center the search
(objects/sv_select.cpp:448-709 SV_Position/SV_Predict, mask :710).

Works from any Ephemeris-shaped orbit record (almanacs are reduced-
precision ephemerides with the same Kepler fields).

Copied from gnsstpu/nav/visibility.py; only the import prefix differs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from gnsstpu_torch.config import SPEED_OF_LIGHT
from gnsstpu_torch.nav import geodesy, orbits
from gnsstpu_torch.nav.types import Ephemeris


@dataclasses.dataclass
class SvPrediction:
    prn: int
    az_deg: float
    el_deg: float
    range_m: float
    doppler_hz: float       # carrier Doppler seen at rx (static receiver)
    visible: bool


def predict(ephs: Dict[int, Ephemeris], t_gps_s: float,
            rx_ecef: np.ndarray, carrier_hz: float,
            mask_deg: float = 10.0) -> List[SvPrediction]:
    """Per-SV az/el/range/Doppler at GPS time t for a static receiver.

    Doppler from the numerical range rate over +-0.5 s (the reference
    differentiates predicted pseudoranges the same way).
    """
    prns = sorted(ephs)
    eph_list = [ephs[p] for p in prns]
    out = []
    pos0, _ = orbits.satpos(np.full(len(prns), t_gps_s - 0.5), eph_list)
    pos1, _ = orbits.satpos(np.full(len(prns), t_gps_s + 0.5), eph_list)
    for i, prn in enumerate(prns):
        mid = 0.5 * (pos0[i] + pos1[i])
        az, el, dist = (np.asarray(v).reshape(-1)[0] for v in
                        geodesy.topocent(rx_ecef, mid - rx_ecef))
        r0 = np.linalg.norm(pos0[i] - rx_ecef)
        r1 = np.linalg.norm(pos1[i] - rx_ecef)
        rate = r1 - r0                       # m/s over 1 s
        dopp = -rate / SPEED_OF_LIGHT * carrier_hz
        out.append(SvPrediction(
            prn=prn, az_deg=float(az), el_deg=float(el),
            range_m=float(dist), doppler_hz=float(dopp),
            visible=bool(el >= mask_deg)))
    return out


def visible_prns(ephs: Dict[int, Ephemeris], t_gps_s: float,
                 rx_ecef: np.ndarray, carrier_hz: float,
                 mask_deg: float = 10.0) -> List[int]:
    return [p.prn for p in predict(ephs, t_gps_s, rx_ecef, carrier_hz,
                                   mask_deg) if p.visible]
