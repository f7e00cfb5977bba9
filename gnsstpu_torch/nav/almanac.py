"""GPS LNAV subframe 4/5 pages: almanac and ionosphere/UTC codec.

The reference decodes almanac pages and UTC/iono parameters in its
realtime receiver (objects/ephemeris.cpp:425 almanac pages, :314
UTC/iono) and uses the almanac for acquisition warm-starts
(sv_select.cpp:448-709 SV_Position/SV_Predict); the GUI dumps/loads them
(gse gui_almanac.cpp). Field layout and scale factors per IS-GPS-200
(almanac: 20.3.3.5.1.2; iono/UTC: 20.3.3.5.1.7-8).

Encoder + decoder (fixture-by-construction testing, like nav.lnav), plus
`to_ephemeris` so nav.visibility can predict from almanacs directly.

Copied from gnsstpu/nav/almanac.py; only the import prefix differs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from gnsstpu_torch.nav.lnav import _bits, _q, _signed, _unsigned, checked_subframes
from gnsstpu_torch.nav.types import Ephemeris

_PI = np.pi
PAGE_IONO_UTC = 56          # SV-ID field value of subframe 4 page 18
_I0_REF_SC = 0.30           # reference inclination [semicircles]


@dataclasses.dataclass
class Almanac:
    prn: int = 0
    e: float = 0.0
    t_oa: float = 0.0
    delta_i: float = 0.0       # rad, offset from 0.30 semicircles
    omegaDot: float = 0.0      # rad/s
    health: int = 0
    sqrtA: float = 0.0
    omega_0: float = 0.0       # rad
    omega: float = 0.0         # rad
    M_0: float = 0.0           # rad
    a_f0: float = 0.0
    a_f1: float = 0.0

    def to_ephemeris(self, week: int = 0) -> Ephemeris:
        """Reduced-precision Ephemeris for orbit/visibility prediction
        (the almanac is a Kepler set with zero harmonic terms)."""
        return Ephemeris(
            week=week, t_oc=self.t_oa, a_f0=self.a_f0, a_f1=self.a_f1,
            e=self.e, sqrtA=self.sqrtA, t_oe=self.t_oa, M_0=self.M_0,
            omega_0=self.omega_0, omega=self.omega,
            i_0=_I0_REF_SC * _PI + self.delta_i,
            omegaDot=self.omegaDot, valid=True)


@dataclasses.dataclass
class IonoUtc:
    alpha0: float = 0.0
    alpha1: float = 0.0
    alpha2: float = 0.0
    alpha3: float = 0.0
    beta0: float = 0.0
    beta1: float = 0.0
    beta2: float = 0.0
    beta3: float = 0.0
    A1: float = 0.0
    A0: float = 0.0
    t_ot: float = 0.0
    WN_t: int = 0
    dt_ls: int = 0
    WN_lsf: int = 0
    DN: int = 0
    dt_lsf: int = 0


def almanac_page_words(alm: Almanac) -> List[np.ndarray]:
    """8 x 24-bit source words (words 3..10) of one almanac page."""
    w = []
    w.append(np.concatenate([
        _bits(1, 2), _bits(alm.prn, 6),                     # data ID, SV ID
        _bits(_q(alm.e, 2.0 ** -21, 16), 16)]))
    w.append(np.concatenate([
        _bits(int(alm.t_oa) >> 12, 8),
        _bits(_q(alm.delta_i / _PI, 2.0 ** -19, 16), 16)]))
    w.append(np.concatenate([
        _bits(_q(alm.omegaDot / _PI, 2.0 ** -38, 16), 16),
        _bits(alm.health, 8)]))
    w.append(_bits(_q(alm.sqrtA, 2.0 ** -11, 24), 24))
    w.append(_bits(_q(alm.omega_0 / _PI, 2.0 ** -23, 24), 24))
    w.append(_bits(_q(alm.omega / _PI, 2.0 ** -23, 24), 24))
    w.append(_bits(_q(alm.M_0 / _PI, 2.0 ** -23, 24), 24))
    af0 = _q(alm.a_f0, 2.0 ** -20, 11)
    af1 = _q(alm.a_f1, 2.0 ** -38, 11)
    w.append(np.concatenate([
        _bits(af0 >> 3, 8), _bits(af1, 11), _bits(af0 & 7, 3),
        _bits(0, 2)]))
    return w


def iono_utc_page_words(iu: IonoUtc) -> List[np.ndarray]:
    """8 x 24-bit source words of subframe 4 page 18 (iono + UTC)."""
    w = []
    w.append(np.concatenate([
        _bits(1, 2), _bits(PAGE_IONO_UTC, 6),
        _bits(_q(iu.alpha0, 2.0 ** -30, 8), 8),
        _bits(_q(iu.alpha1, 2.0 ** -27, 8), 8)]))
    w.append(np.concatenate([
        _bits(_q(iu.alpha2, 2.0 ** -24, 8), 8),
        _bits(_q(iu.alpha3, 2.0 ** -24, 8), 8),
        _bits(_q(iu.beta0, 2.0 ** 11, 8), 8)]))
    w.append(np.concatenate([
        _bits(_q(iu.beta1, 2.0 ** 14, 8), 8),
        _bits(_q(iu.beta2, 2.0 ** 16, 8), 8),
        _bits(_q(iu.beta3, 2.0 ** 16, 8), 8)]))
    w.append(_bits(_q(iu.A1, 2.0 ** -50, 24), 24))
    a0 = _q(iu.A0, 2.0 ** -30, 32)
    w.append(_bits(a0 >> 8, 24))
    w.append(np.concatenate([
        _bits(a0 & 0xFF, 8), _bits(int(iu.t_ot) >> 12, 8),
        _bits(iu.WN_t, 8)]))
    w.append(np.concatenate([
        _bits(iu.dt_ls & 0xFF, 8), _bits(iu.WN_lsf, 8),
        _bits(iu.DN, 8)]))
    w.append(np.concatenate([
        _bits(iu.dt_lsf & 0xFF, 8), _bits(0, 14), _bits(0, 2)]))
    return w


def decode_page(d: np.ndarray):
    """Decode the 192 source bits of one subframe 4/5 page.

    Returns ('almanac', Almanac), ('iono_utc', IonoUtc), or
    ('other', sv_id) for pages the framework does not model.
    """
    sv_id = _unsigned(d[2:8])
    if 1 <= sv_id <= 32:
        alm = Almanac(
            prn=sv_id,
            e=_unsigned(d[8:24]) * 2.0 ** -21,
            t_oa=_unsigned(d[24:32]) * 2.0 ** 12,
            delta_i=_signed(d[32:48]) * 2.0 ** -19 * _PI,
            omegaDot=_signed(d[48:64]) * 2.0 ** -38 * _PI,
            health=_unsigned(d[64:72]),
            sqrtA=_unsigned(d[72:96]) * 2.0 ** -11,
            omega_0=_signed(d[96:120]) * 2.0 ** -23 * _PI,
            omega=_signed(d[120:144]) * 2.0 ** -23 * _PI,
            M_0=_signed(d[144:168]) * 2.0 ** -23 * _PI,
            a_f0=_signed(np.concatenate([d[168:176], d[187:190]]))
            * 2.0 ** -20,
            a_f1=_signed(d[176:187]) * 2.0 ** -38,
        )
        return "almanac", alm
    if sv_id == PAGE_IONO_UTC:
        iu = IonoUtc(
            alpha0=_signed(d[8:16]) * 2.0 ** -30,
            alpha1=_signed(d[16:24]) * 2.0 ** -27,
            alpha2=_signed(d[24:32]) * 2.0 ** -24,
            alpha3=_signed(d[32:40]) * 2.0 ** -24,
            beta0=_signed(d[40:48]) * 2.0 ** 11,
            beta1=_signed(d[48:56]) * 2.0 ** 14,
            beta2=_signed(d[56:64]) * 2.0 ** 16,
            beta3=_signed(d[64:72]) * 2.0 ** 16,
            A1=_signed(d[72:96]) * 2.0 ** -50,
            A0=_signed(np.concatenate([d[96:120], d[120:128]]))
            * 2.0 ** -30,
            t_ot=_unsigned(d[128:136]) * 2.0 ** 12,
            WN_t=_unsigned(d[136:144]),
            dt_ls=_signed(d[144:152]),
            WN_lsf=_unsigned(d[152:160]),
            DN=_unsigned(d[160:168]),
            dt_lsf=_signed(d[168:176]),
        )
        return "iono_utc", iu
    return "other", sv_id


def decode_pages(bits01: np.ndarray, d30_star: int = 0,
                 d29_star: int = 0
                 ) -> Tuple[Dict[int, Almanac], Optional[IonoUtc], int]:
    """Walk a bit stream (subframe-aligned) and collect almanacs + iono/UTC
    from every parity-clean subframe 4/5 (ephemeris.cpp:425,314 role).

    Also returns the count of parity-clean subframes of ANY id, so a
    caller can distinguish "stream decodes cleanly but the window holds
    no subframe 4/5 pages yet" from "parity-degraded channel"."""
    alms: Dict[int, Almanac] = {}
    iu: Optional[IonoUtc] = None
    n_clean = 0
    for _, sf_id, _, d in checked_subframes(bits01, d30_star,
                                            d29_star):
        n_clean += 1
        if sf_id not in (4, 5):
            continue
        kind, obj = decode_page(d)
        if kind == "almanac":
            alms[obj.prn] = obj
        elif kind == "iono_utc":
            iu = obj
    return alms, iu, n_clean
