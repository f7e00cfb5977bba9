"""Galileo E1B I/NAV message codec: page sync, deinterleave, FEC, words.

Reference semantics reproduced and extended:
  * page sync on the 10-symbol pattern 0101100000 with 1 s spacing check
    (GALILEO/E1/findPageStart.sci:41-75; the reference correlates at a
    1000 Hz prompt cadence and kron-upsamples by 4 — our tracker already
    integrates whole 4 ms code periods, so the stream is natively 250 sps);
  * 8x30 block deinterleave + rate-1/2 K=7 Viterbi
    (GALILEO/E1/include/decode_gll_data.sci:29-41). The reference stops at
    decoded half-pages; this module additionally implements the even/odd
    nominal-page pairing, CRC-24Q verification, and word types 1-5
    (ephemeris + GST + clock) per the Galileo OS ICD so the chain reaches
    a navigation solution (parity with the GPS-side ephemeris.sci role).

Symbol convention: coded bit b -> BPSK level (1 - 2b); +1 means 0.
A page part is 1 s: 10 sync symbols + 240 coded symbols at 250 sps.

Copied from gnsstpu/nav/galileo.py; only the import prefix differs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from gnsstpu_torch.nav import viterbi
from gnsstpu_torch.nav.lnav import _bits, _q, _signed, _unsigned

SYNC_BITS = np.array([0, 1, 0, 1, 1, 0, 0, 0, 0, 0], np.int8)
SYNC_PM = (1 - 2 * SYNC_BITS).astype(np.float32)          # ±1 levels
PAGE_SYMS = 250                                            # 1 s at 250 sps
DATA_SYMS = 240

GAL_PI = 3.1415926535898                                   # semicircle scale


def interleave(syms240: np.ndarray) -> np.ndarray:
    """Block interleaver: write the 240 coded symbols into an 8x30 matrix
    row-by-row, transmit column-by-column (inverse of the reference's
    deinterleave, decode_gll_data.sci:29-32)."""
    return np.asarray(syms240).reshape(30, 8).T.reshape(-1)


def deinterleave(syms240: np.ndarray) -> np.ndarray:
    """Inverse of interleave (accepts soft values)."""
    return np.asarray(syms240).reshape(8, 30).T.reshape(-1)


def crc24q(bits: np.ndarray) -> int:
    """CRC-24Q (poly 0x1864CFB) over a 0/1 bit array, MSB-first."""
    reg = 0
    for b in np.asarray(bits, np.int64):
        reg ^= int(b) << 23
        reg <<= 1
        if reg & 0x1000000:
            reg ^= 0x1864CFB
    return reg & 0xFFFFFF


def encode_page_part(bits114: np.ndarray) -> np.ndarray:
    """114 data bits -> 250 ±1 symbols (sync + FEC(120) interleaved)."""
    syms = viterbi.conv_encode(np.asarray(bits114, np.int8))   # 240 x {0,1}
    levels = (1 - 2 * interleave(syms)).astype(np.float32)
    return np.concatenate([SYNC_PM, levels])


def decode_page_part(soft250: np.ndarray) -> Tuple[bool, np.ndarray]:
    """Soft 250-symbol page part -> (sync_ok, 114 decoded bits).

    Polarity is taken from the sync correlation sign, as in
    findPageStart.sci (abs() on the correlation, sign resolved per hit).
    """
    s = np.asarray(soft250, np.float64)
    c = float(np.dot(np.sign(s[:10]), SYNC_PM))
    if abs(c) < 8:
        return False, np.zeros(114, np.int8)
    pol = 1.0 if c > 0 else -1.0
    soft = deinterleave(pol * s[10:250])
    bits = viterbi.viterbi_decode(soft)
    return True, bits


def find_page_start(prompt_ip: np.ndarray) -> Tuple[int, int]:
    """Locate the first page-part boundary in a 250 sps prompt-I stream.

    Returns (index, polarity) or (-1, 0). Sync correlation with a
    1 s (250-symbol) spacing confirmation, findPageStart.sci:41-75.
    """
    s = np.sign(np.asarray(prompt_ip, np.float64) + 1e-30)
    if len(s) < PAGE_SYMS + 10:
        return -1, 0
    corr = np.correlate(s, SYNC_PM, mode="valid")
    hits = np.nonzero(np.abs(corr) >= 10)[0]
    for h in hits:
        nxt = h + PAGE_SYMS
        if nxt < len(corr) and abs(corr[nxt]) >= 9 and \
                corr[nxt] * corr[h] != 0:
            return int(h), (1 if corr[h] > 0 else -1)
    return -1, 0


# ---------------------------------------------------------------------------
# Nominal pages (even/odd pairs) and word types 1-5
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GalileoEphemeris:
    """I/NAV words 1-5 content (Galileo OS ICD; fields mirror the GPS
    Ephemeris naming where the quantity is the same)."""

    IODnav: int = 0
    t_oe: float = 0.0            # [s], scale 60
    M_0: float = 0.0             # [semicircles -> rad on use]
    e: float = 0.0
    sqrtA: float = 0.0
    omega_0: float = 0.0
    i_0: float = 0.0
    omega: float = 0.0
    iDot: float = 0.0
    omegaDot: float = 0.0
    deltan: float = 0.0
    C_uc: float = 0.0
    C_us: float = 0.0
    C_rc: float = 0.0
    C_rs: float = 0.0
    SISA: int = 107
    SVID: int = 1
    C_ic: float = 0.0
    C_is: float = 0.0
    t_oc: float = 0.0
    a_f0: float = 0.0
    a_f1: float = 0.0
    a_f2: float = 0.0
    ai0: float = 0.0
    ai1: float = 0.0
    ai2: float = 0.0
    BGD_E1E5a: float = 0.0
    BGD_E1E5b: float = 0.0
    health_E1B: int = 0
    WN: int = 0                  # GST week in word 5
    TOW: int = 0                 # GST TOW [s] in word 5
    valid: bool = False


_SC = GAL_PI  # semicircle -> value scaling base used with 2^-x factors


def _word_bits(eph: GalileoEphemeris, wtype: int, tow: int) -> np.ndarray:
    """128-bit I/NAV word (type 6 bits + 122 content bits)."""
    b: List[np.ndarray] = [_bits(wtype, 6)]
    if wtype == 1:
        b += [_bits(eph.IODnav, 10), _bits(_q(eph.t_oe, 60.0, 14), 14),
              _bits(_q(eph.M_0, 2.0 ** -31 * _SC, 32), 32),
              _bits(_q(eph.e, 2.0 ** -33, 32), 32),
              _bits(_q(eph.sqrtA, 2.0 ** -19, 32), 32), _bits(0, 2)]
    elif wtype == 2:
        b += [_bits(eph.IODnav, 10),
              _bits(_q(eph.omega_0, 2.0 ** -31 * _SC, 32), 32),
              _bits(_q(eph.i_0, 2.0 ** -31 * _SC, 32), 32),
              _bits(_q(eph.omega, 2.0 ** -31 * _SC, 32), 32),
              _bits(_q(eph.iDot, 2.0 ** -43 * _SC, 14), 14), _bits(0, 2)]
    elif wtype == 3:
        b += [_bits(eph.IODnav, 10),
              _bits(_q(eph.omegaDot, 2.0 ** -43 * _SC, 24), 24),
              _bits(_q(eph.deltan, 2.0 ** -43 * _SC, 16), 16),
              _bits(_q(eph.C_uc, 2.0 ** -29, 16), 16),
              _bits(_q(eph.C_us, 2.0 ** -29, 16), 16),
              _bits(_q(eph.C_rc, 2.0 ** -5, 16), 16),
              _bits(_q(eph.C_rs, 2.0 ** -5, 16), 16),
              _bits(eph.SISA, 8)]
    elif wtype == 4:
        b += [_bits(eph.IODnav, 10), _bits(eph.SVID, 6),
              _bits(_q(eph.C_ic, 2.0 ** -29, 16), 16),
              _bits(_q(eph.C_is, 2.0 ** -29, 16), 16),
              _bits(_q(eph.t_oc, 60.0, 14), 14),
              _bits(_q(eph.a_f0, 2.0 ** -34, 31), 31),
              _bits(_q(eph.a_f1, 2.0 ** -46, 21), 21),
              _bits(_q(eph.a_f2, 2.0 ** -59, 6), 6), _bits(0, 2)]
    elif wtype == 5:
        b += [_bits(_q(eph.ai0, 2.0 ** -2, 11), 11),
              _bits(_q(eph.ai1, 2.0 ** -8, 11), 11),
              _bits(_q(eph.ai2, 2.0 ** -15, 14), 14),
              _bits(0, 5),
              _bits(_q(eph.BGD_E1E5a, 2.0 ** -32, 10), 10),
              _bits(_q(eph.BGD_E1E5b, 2.0 ** -32, 10), 10),
              _bits(0, 2), _bits(eph.health_E1B, 2), _bits(0, 2),
              _bits(eph.WN, 12), _bits(tow, 20), _bits(0, 23)]
    else:
        b += [_bits(0, 122)]
    word = np.concatenate(b)
    assert word.shape == (128,), (wtype, word.shape)
    return word


def _parse_word(word: np.ndarray, eph: GalileoEphemeris) -> int:
    wtype = _unsigned(word[0:6])
    w = word
    if wtype == 1:
        eph.IODnav = _unsigned(w[6:16])
        eph.t_oe = _unsigned(w[16:30]) * 60.0
        eph.M_0 = _signed(w[30:62]) * 2.0 ** -31 * _SC
        eph.e = _unsigned(w[62:94]) * 2.0 ** -33
        eph.sqrtA = _unsigned(w[94:126]) * 2.0 ** -19
    elif wtype == 2:
        eph.IODnav = _unsigned(w[6:16])
        eph.omega_0 = _signed(w[16:48]) * 2.0 ** -31 * _SC
        eph.i_0 = _signed(w[48:80]) * 2.0 ** -31 * _SC
        eph.omega = _signed(w[80:112]) * 2.0 ** -31 * _SC
        eph.iDot = _signed(w[112:126]) * 2.0 ** -43 * _SC
    elif wtype == 3:
        eph.IODnav = _unsigned(w[6:16])
        eph.omegaDot = _signed(w[16:40]) * 2.0 ** -43 * _SC
        eph.deltan = _signed(w[40:56]) * 2.0 ** -43 * _SC
        eph.C_uc = _signed(w[56:72]) * 2.0 ** -29
        eph.C_us = _signed(w[72:88]) * 2.0 ** -29
        eph.C_rc = _signed(w[88:104]) * 2.0 ** -5
        eph.C_rs = _signed(w[104:120]) * 2.0 ** -5
        eph.SISA = _unsigned(w[120:128])
    elif wtype == 4:
        eph.IODnav = _unsigned(w[6:16])
        eph.SVID = _unsigned(w[16:22])
        eph.C_ic = _signed(w[22:38]) * 2.0 ** -29
        eph.C_is = _signed(w[38:54]) * 2.0 ** -29
        eph.t_oc = _unsigned(w[54:68]) * 60.0
        eph.a_f0 = _signed(w[68:99]) * 2.0 ** -34
        eph.a_f1 = _signed(w[99:120]) * 2.0 ** -46
        eph.a_f2 = _signed(w[120:126]) * 2.0 ** -59
    elif wtype == 5:
        eph.ai0 = _unsigned(w[6:17]) * 2.0 ** -2
        eph.ai1 = _signed(w[17:28]) * 2.0 ** -8
        eph.ai2 = _signed(w[28:42]) * 2.0 ** -15
        eph.BGD_E1E5a = _signed(w[47:57]) * 2.0 ** -32
        eph.BGD_E1E5b = _signed(w[57:67]) * 2.0 ** -32
        eph.health_E1B = _unsigned(w[69:71])
        eph.WN = _unsigned(w[73:85])
        eph.TOW = _unsigned(w[85:105])
    return wtype


def encode_page_pair(word128: np.ndarray) -> np.ndarray:
    """One nominal page (2 s): even part + odd part, 500 ±1 symbols.

    Layout (OS ICD E1B nominal page):
      even: [eo=0, type=0, data1(112)]                       -> 114 bits
      odd:  [eo=1, type=0, data2(16), osnma(40)=0, sar(22)=0,
             spare(2)=0, CRC24(24), ssp(8)=0]                -> 114 bits
    CRC-24Q over even(114) + odd's first 82 bits.
    """
    w = np.asarray(word128, np.int8)
    even = np.concatenate([[0, 0], w[:112]]).astype(np.int8)
    odd_head = np.concatenate([[1, 0], w[112:128],
                               np.zeros(64, np.int8)]).astype(np.int8)
    crc = crc24q(np.concatenate([even, odd_head]))
    odd = np.concatenate([odd_head, _bits(crc, 24), np.zeros(8, np.int8)])
    return np.concatenate([encode_page_part(even), encode_page_part(odd)])


def decode_page_pair(soft500: np.ndarray
                     ) -> Tuple[bool, Optional[np.ndarray]]:
    """Two consecutive page parts -> (crc_ok, 128-bit word) or (False, None)."""
    ok_e, even = decode_page_part(soft500[:PAGE_SYMS])
    ok_o, odd = decode_page_part(soft500[PAGE_SYMS:2 * PAGE_SYMS])
    if not (ok_e and ok_o) or even[0] != 0 or odd[0] != 1:
        return False, None
    if crc24q(np.concatenate([even, odd[:82]])) != _unsigned(odd[82:106]):
        return False, None
    return True, np.concatenate([even[2:114], odd[2:18]])


_NOMINAL_SEQ = (1, 2, 3, 4, 5)


def encode_frames(eph: GalileoEphemeris, tow0: int = 0,
                  n_pages: int = 10) -> np.ndarray:
    """±1 symbol stream of n_pages nominal pages cycling word types 1-5.

    tow0 is the GST TOW at the start of the first page; word 5's TOW
    field stamps the start of its own page (tow0 + 2*k)."""
    parts = []
    for k in range(n_pages):
        wtype = _NOMINAL_SEQ[k % len(_NOMINAL_SEQ)]
        parts.append(encode_page_pair(
            _word_bits(eph, wtype, tow0 + 2 * k)))
    return np.concatenate(parts)


def _decode_aligned(s: np.ndarray) -> Tuple[GalileoEphemeris,
                                            Optional[int], int]:
    eph = GalileoEphemeris()
    seen = {}
    tow0 = None
    n_pairs = len(s) // (2 * PAGE_SYMS)
    n_ok = 0
    for k in range(n_pairs):
        ok, word = decode_page_pair(s[2 * k * PAGE_SYMS:
                                      2 * (k + 1) * PAGE_SYMS])
        if not ok:
            continue
        n_ok += 1
        wtype = _parse_word(word, eph)
        if 1 <= wtype <= 5:
            seen[wtype] = eph.IODnav if wtype <= 4 else seen.get(wtype)
        if wtype == 5 and tow0 is None:
            tow0 = eph.TOW - 2 * k
    iods = {seen.get(t) for t in (1, 2, 3, 4)}
    eph.valid = all(t in seen for t in _NOMINAL_SEQ) and len(iods) == 1
    return eph, tow0, n_ok


def decode_frames(prompt_ip: np.ndarray, start: int
                  ) -> Tuple[GalileoEphemeris, Optional[int]]:
    """Decode nominal pages from a 250 sps prompt stream.

    `start` must be a page-part boundary (from find_page_start); pairing
    (even-before-odd) is resolved here by trying both half-page offsets —
    sync patterns precede both halves, so find_page_start alone cannot
    distinguish them. Returns (ephemeris, TOW at `start`); TOW needs a
    decoded word 5. valid=True once words 1-5 all pass CRC with a single
    IODnav.
    """
    s = np.asarray(prompt_ip, np.float64)[start:]
    eph0, tow0, ok0 = _decode_aligned(s)
    eph1, tow1, ok1 = _decode_aligned(s[PAGE_SYMS:])
    if ok1 > ok0:
        return eph1, (None if tow1 is None else tow1 - 1)
    return eph0, tow0


# ---------------------------------------------------------------------------
# Orbit adapters for pvt.navigate (GTRF Kepler; Galileo OS ICD constants)
# ---------------------------------------------------------------------------

GAL_GM = 3.986004418e14        # [m^3/s^2]
GAL_OMEGA_E = 7.2921151467e-5  # [rad/s]


def to_kepler(eph: GalileoEphemeris):
    """GalileoEphemeris -> the shared Kepler Ephemeris record (fields are
    stored in the same units: radians, seconds, meters^0.5); the E1 single-
    frequency group delay is BGD(E1,E5b) (OS ICD 5.1.5)."""
    from gnsstpu_torch.nav.types import Ephemeris as GpsEph

    return GpsEph(
        t_oc=eph.t_oc, a_f0=eph.a_f0, a_f1=eph.a_f1, a_f2=eph.a_f2,
        T_GD=eph.BGD_E1E5b, sqrtA=eph.sqrtA, e=eph.e, M_0=eph.M_0,
        deltan=eph.deltan, omega=eph.omega, omega_0=eph.omega_0,
        omegaDot=eph.omegaDot, i_0=eph.i_0, iDot=eph.iDot, t_oe=eph.t_oe,
        C_uc=eph.C_uc, C_us=eph.C_us, C_rc=eph.C_rc, C_rs=eph.C_rs,
        C_ic=eph.C_ic, C_is=eph.C_is, valid=eph.valid)


def satpos_gal(transmit_time, ephs) -> Tuple[np.ndarray, np.ndarray]:
    """pvt.navigate satpos_fn adapter: (pos [S,3] m, clk [S] s)."""
    from gnsstpu_torch.nav.orbits import satpos

    return satpos(transmit_time, [to_kepler(e) for e in ephs],
                  gm=GAL_GM, omega_e=GAL_OMEGA_E)


def satpos_vel_gal(transmit_time, ephs, dt: float = 0.5
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """pvt.navigate satvel_fn adapter (orbits.central_diff_vel)."""
    from gnsstpu_torch.nav.orbits import central_diff_vel

    return central_diff_vel(satpos_gal, transmit_time, ephs, dt)
