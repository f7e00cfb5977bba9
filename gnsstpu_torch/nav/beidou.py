"""BeiDou D1 navigation message: NH overlay, BCH, frame codec, orbits.

Reference semantics:
  - NH(20) wipeoff + 20 ms integration + preamble polarity + word
    deinterleave: COMPASS/B1/include/decode_bd_data.sci:1-25;
  - subframe field extraction (two's-complement scalings):
    COMPASS/B1/include/ephemeris.sci:1-123 (two known sign-bit slips in
    the reference's alpha3/beta1 extraction are fixed here — the MSB of
    the field itself is used);
  - subframe sync on preamble (x) NH: COMPASS/B1/findSubframeStart.sci.

Additions over the reference: proper BCH(15,11,1) encode/verify
(g(x) = x^4 + x + 1 per the BeiDou ICD) — the reference ignores parity
bits entirely.

D1 (MEO/IGSO) only; the GEO D2 format is out of scope here, as in the
reference.

Copied from gnsstpu/nav/beidou.py; only the import prefix differs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from gnsstpu_torch.signals.beidou_b1 import NH_CODE

# ±1 preamble, symbol s = 2*bit - 1 (decode_bd_data.sci:6).
PREAMBLE_PM1 = np.array([1, 1, 1, -1, -1, -1, 1, -1, -1, 1, -1], np.float64)
BD_PI = 3.1415926535898
SUBFRAME_MS = 6000
BITS_PER_SUBFRAME = 300


@dataclasses.dataclass
class BeiDouEphemeris:
    """D1 broadcast ephemeris (subframes 1-3 fields, ephemeris.sci names)."""

    SatH1: int = 0
    IODC: int = 0
    URAI: int = 0
    WN: int = 0
    t_oc: float = 0.0
    T_GD_1: float = 0.0
    alpha0: float = 0.0
    alpha1: float = 0.0
    alpha2: float = 0.0
    alpha3: float = 0.0
    beta0: float = 0.0
    beta1: float = 0.0
    beta2: float = 0.0
    beta3: float = 0.0
    a0: float = 0.0
    a1: float = 0.0
    a2: float = 0.0
    IODE: int = 0
    deltan: float = 0.0
    C_uc: float = 0.0
    M_0: float = 0.0
    e: float = 0.0
    C_us: float = 0.0
    C_rc: float = 0.0
    C_rs: float = 0.0
    sqrtA: float = 0.0
    t_oe: float = 0.0
    i_0: float = 0.0
    C_ic: float = 0.0
    omegaDot: float = 0.0
    C_is: float = 0.0
    iDot: float = 0.0
    omega_0: float = 0.0
    omega: float = 0.0
    valid: bool = False


# (field, lo, hi, signed, scale) — 1-based inclusive indices into the
# 213-bit decoded content array (ephemeris.sci layout).
_SF1 = [
    ("SatH1", 28, 28, False, 1), ("IODC", 29, 33, False, 1),
    ("URAI", 34, 37, False, 1), ("WN", 38, 50, False, 1),
    ("t_oc", 51, 67, False, 2.0 ** 3), ("T_GD_1", 68, 77, True, 0.1e-9),
    ("alpha0", 88, 95, True, 2.0 ** -30),
    ("alpha1", 96, 103, True, 2.0 ** -27),
    ("alpha2", 104, 111, True, 2.0 ** -24),
    ("alpha3", 112, 119, True, 2.0 ** -24),
    ("beta0", 120, 127, True, 2.0 ** 11),
    ("beta1", 128, 135, True, 2.0 ** 14),
    ("beta2", 136, 143, True, 2.0 ** 16),
    ("beta3", 144, 151, True, 2.0 ** 16),
    ("a2", 152, 162, True, 2.0 ** -66), ("a0", 163, 186, True, 2.0 ** -33),
    ("a1", 187, 208, True, 2.0 ** -50), ("IODE", 209, 213, False, 1),
]
_SF2 = [
    ("deltan", 28, 43, True, 2.0 ** -43 * BD_PI),
    ("C_uc", 44, 61, True, 2.0 ** -31),
    ("M_0", 62, 93, True, 2.0 ** -31 * BD_PI),
    ("e", 94, 125, False, 2.0 ** -33),
    ("C_us", 126, 143, True, 2.0 ** -31),
    ("C_rc", 144, 161, True, 2.0 ** -6),
    ("C_rs", 162, 179, True, 2.0 ** -6),
    ("sqrtA", 180, 211, False, 2.0 ** -19),
    ("t_oe_msb", 212, 213, False, 2.0 ** 18),
]
_SF3 = [
    ("t_oe_lsb", 28, 42, False, 2.0 ** 3),
    ("i_0", 43, 74, True, 2.0 ** -31 * BD_PI),
    ("C_ic", 75, 92, True, 2.0 ** -31),
    ("omegaDot", 93, 116, True, 2.0 ** -43 * BD_PI),
    ("C_is", 117, 134, True, 2.0 ** -31),
    ("iDot", 135, 148, True, 2.0 ** -43 * BD_PI),
    ("omega_0", 149, 180, True, 2.0 ** -31 * BD_PI),
    ("omega", 181, 212, True, 2.0 ** -31 * BD_PI),
]
_FIELDS = {1: _SF1, 2: _SF2, 3: _SF3}


# ---------------------------------------------------------------------------
# BCH(15,11,1), g(x) = x^4 + x + 1
# ---------------------------------------------------------------------------

def bch15_parity(info11: np.ndarray) -> np.ndarray:
    """4 parity bits for 11 info bits (systematic BCH(15,11))."""
    reg = [0, 0, 0, 0]
    for b in info11:
        fb = int(b) ^ reg[3]
        reg[3] = reg[2]
        reg[2] = reg[1]
        reg[1] = reg[0] ^ fb
        reg[0] = fb
    return np.array(reg[::-1], np.int8)


def bch15_check(word15: np.ndarray) -> Tuple[bool, np.ndarray]:
    """Verify/correct a 15-bit word (11 info + 4 parity).

    Returns (ok, corrected_info11); single-bit errors are corrected.
    """
    w = np.asarray(word15, np.int8).copy()
    par = bch15_parity(w[:11])
    synd = (par ^ w[11:15])
    if not synd.any():
        return True, w[:11]
    # Single-error correction: try flipping each of the 15 bits.
    for k in range(15):
        w2 = w.copy()
        w2[k] ^= 1
        if not (bch15_parity(w2[:11]) ^ w2[11:15]).any():
            return True, w2[:11]
    return False, w[:11]


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------

def _put(content: np.ndarray, lo: int, hi: int, value: int):
    n = hi - lo + 1
    v = int(value) & ((1 << n) - 1)
    for i in range(n):
        content[lo - 1 + i] = (v >> (n - 1 - i)) & 1


def _get(content: np.ndarray, lo: int, hi: int, signed: bool) -> int:
    v = 0
    for i in range(lo - 1, hi):
        v = (v << 1) | int(content[i])
    n = hi - lo + 1
    if signed and v >= (1 << (n - 1)):
        v -= 1 << n
    return v


def encode_subframe(eph: BeiDouEphemeris, sf_id: int, sow: int
                    ) -> np.ndarray:
    """One D1 subframe as 300 0/1 bits (pre-NH).

    Content layout per decode_bd_data.sci inverse: word 1 carries
    preamble(11) + content[1..15] + parity(4); words 2..10 carry two
    interleaved BCH(15,11) blocks of content bits.
    """
    content = np.zeros(213, np.int8)
    _put(content, 5, 7, sf_id)
    _put(content, 8, 27, sow)
    for name, lo, hi, signed, scale in _FIELDS.get(sf_id, []):
        if name == "t_oe_msb":
            val = int(round(eph.t_oe / 8.0)) >> 15
        elif name == "t_oe_lsb":
            val = int(round(eph.t_oe / 8.0)) & 0x7FFF
        else:
            val = int(round(getattr(eph, name) / scale))
        _put(content, lo, hi, val)

    tx = np.zeros(BITS_PER_SUBFRAME, np.int8)
    tx[:11] = (PREAMBLE_PM1 > 0).astype(np.int8)
    tx[11:26] = content[:15]
    tx[26:30] = bch15_parity(content[4:15])   # word-1 parity (unchecked)
    for w in range(9):
        blk1 = content[15 + 22 * w: 26 + 22 * w]
        blk2 = content[26 + 22 * w: 37 + 22 * w]
        par1 = bch15_parity(blk1)
        par2 = bch15_parity(blk2)
        word = np.zeros(30, np.int8)
        word[0:22:2] = blk1
        word[1:22:2] = blk2
        word[22:30:2] = par1
        word[23:31:2] = par2
        tx[30 * (w + 1): 30 * (w + 2)] = word
    return tx


def encode_symbols(eph: BeiDouEphemeris, sow0: int, n_subframes: int = 5
                   ) -> np.ndarray:
    """±1 symbol stream at 1 ms (bit x NH chip) for subframes 1..n."""
    out = []
    for k in range(n_subframes):
        sf = k % 5 + 1
        bits = encode_subframe(eph, sf, sow0 + 6 * k)
        pm1 = 2.0 * bits - 1.0
        out.append(np.repeat(pm1, 20) * np.tile(NH_CODE, len(bits)))
    return np.concatenate(out)


def find_subframe(prompt_i: np.ndarray) -> Tuple[int, int]:
    """(ms index of first subframe start, polarity) or (-1, 0).

    Correlates preamble (x) NH over the prompt stream
    (findSubframeStart.sci) and confirms 6000 ms spacing when possible.
    """
    s = np.sign(np.asarray(prompt_i, np.float64))
    pat = np.repeat(PREAMBLE_PM1, 20) * np.tile(NH_CODE, 11)
    if len(s) < len(pat):
        return -1, 0
    corr = np.correlate(s, pat, mode="valid")
    idx = np.nonzero(np.abs(corr) > 215.0)[0]
    for i0 in idx:
        nxt = i0 + SUBFRAME_MS
        if nxt < len(corr) and abs(corr[nxt]) <= 215.0:
            continue
        return int(i0), int(np.sign(corr[i0]))
    return -1, 0


def decode_subframe_ms(prompt_ms: np.ndarray) -> Optional[np.ndarray]:
    """6000 ms of prompt-I (subframe-aligned) -> 213-bit content or None.

    decode_bd_data.sci: NH wipeoff, 20 ms sums, preamble polarity fix,
    deinterleave; plus BCH verification (reference skips it).
    """
    x = np.asarray(prompt_ms[:SUBFRAME_MS], np.float64)
    if len(x) < SUBFRAME_MS:
        return None
    nd = (x * np.tile(NH_CODE, BITS_PER_SUBFRAME)).reshape(300, 20).sum(
        axis=1)
    nd = np.sign(nd)
    if np.any(nd == 0):
        return None
    if np.sum(nd[:11] * PREAMBLE_PM1) < 0:
        nd = -nd
    bits = ((nd + 1) / 2).astype(np.int8)
    content = np.zeros(213, np.int8)
    content[:15] = bits[11:26]
    for w in range(9):
        word = bits[30 * (w + 1): 30 * (w + 2)]
        ok1, blk1 = bch15_check(np.concatenate([word[0:22:2],
                                                word[22:30:2]]))
        ok2, blk2 = bch15_check(np.concatenate([word[1:22:2],
                                                word[23:31:2]]))
        if not (ok1 and ok2):
            return None
        content[15 + 22 * w: 26 + 22 * w] = blk1
        content[26 + 22 * w: 37 + 22 * w] = blk2
    return content


def decode_subframes(prompt_i: np.ndarray, start_ms: int,
                     n_subframes: int = 5
                     ) -> Tuple[BeiDouEphemeris, Optional[float]]:
    """Decode ephemeris from subframe-aligned prompt stream.

    Returns (eph, t) with t = SOW of the FIRST subframe start [s]
    (ephemeris.sci:123 computes SOW(last) - 24 for a 5-subframe window;
    here any decoded subframe anchors it).
    """
    eph = BeiDouEphemeris()
    got = set()
    t: Optional[float] = None
    toe_msb = toe_lsb = 0.0
    for k in range(n_subframes):
        content = decode_subframe_ms(
            prompt_i[start_ms + k * SUBFRAME_MS:])
        if content is None:
            continue
        sf_id = _get(content, 5, 7, False)
        sow = _get(content, 8, 27, False)
        if t is None:
            t = float(sow - 6 * k)
        for name, lo, hi, signed, scale in _FIELDS.get(sf_id, []):
            val = _get(content, lo, hi, signed) * scale
            if name == "t_oe_msb":
                toe_msb = val
            elif name == "t_oe_lsb":
                toe_lsb = val
            elif name in ("SatH1", "IODC", "URAI", "WN", "IODE"):
                setattr(eph, name, int(val))
            else:
                setattr(eph, name, float(val))
        got.add(sf_id)
    eph.t_oe = toe_msb + toe_lsb
    eph.valid = got >= {1, 2, 3}
    return eph, t


def satpos_bd(transmit_time, ephs) -> Tuple[np.ndarray, np.ndarray]:
    """CGCS2000 MEO/IGSO positions + clock from D1 ephemeris.

    Same Kepler pipeline as GPS (orbits.satpos) with BeiDou constants;
    clock uses a0/a1/a2 and T_GD_1. transmit_time is in BDT seconds of
    week.
    """
    from gnsstpu_torch.nav.orbits import satpos
    from gnsstpu_torch.nav.types import Ephemeris as GpsEph

    conv = [GpsEph(
        t_oc=e.t_oc, a_f0=e.a0, a_f1=e.a1, a_f2=e.a2, T_GD=e.T_GD_1,
        sqrtA=e.sqrtA, e=e.e, M_0=e.M_0, deltan=e.deltan, omega=e.omega,
        omega_0=e.omega_0, omegaDot=e.omegaDot, i_0=e.i_0, iDot=e.iDot,
        t_oe=e.t_oe, C_uc=e.C_uc, C_us=e.C_us, C_rc=e.C_rc, C_rs=e.C_rs,
        C_ic=e.C_ic, C_is=e.C_is, valid=e.valid) for e in ephs]
    return satpos(transmit_time, conv, gm=3.986004418e14,
                  omega_e=7.2921150e-5)


def satpos_vel_bd(transmit_time, ephs, dt: float = 0.5
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """pvt.navigate satvel_fn adapter: central-difference velocity of
    the CGCS2000 Kepler propagator (orbits.central_diff_vel)."""
    from gnsstpu_torch.nav.orbits import central_diff_vel

    return central_diff_vel(satpos_bd, transmit_time, ephs, dt)
