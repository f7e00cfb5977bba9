"""GLONASS navigation message: time marks, string codec, PZ-90 orbits.

Reference semantics:
  - time-mark sync: GLONASS/L1/findTimeMarks.sci:1-22 (30-bit PR sequence
    at 100 bit/s, correlation over ms-cadence prompt signs);
  - string ("relative code") decode: GLONASS/L1/include/decode_gl_data.sci
    (meander wipeoff, 20 ms integration, differential product decode);
  - ephemeris strings 1-5 field extraction (sign-magnitude scalings):
    GLONASS/L1/include/ephemeris.sci:1-100;
  - PZ-90 equations of motion, RK4, 10 s steps + J2 (c20):
    GLONASS/L1/geoFunctions/satposg.sci:1-314; clock = taun - gamman*dt
    (satposg.sci:310).

String structure (2 s): 1.7 s of data — 85 twenty-ms slots encoding 84
bits in relative (differential) code under a 100 Hz meander — then the
0.3 s time mark. The encoder exists for fixture-by-construction testing;
decode(encode(eph)) must round-trip bit-exactly. All polarity-invariant
(differential data; |correlation| time-mark detection).

Copied from gnsstpu/nav/glonass.py; only the import prefix differs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

# ICD time mark: 30-bit PR sequence, first-transmitted bit first.
TIME_MARK_BITS = np.array(
    [1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 0, 1, 1, 1, 0, 1, 0, 1, 0, 0, 0, 0, 1,
     0, 0, 1, 0, 1, 1, 0], np.int8)
TIME_MARK_PM1 = (1 - 2 * TIME_MARK_BITS).astype(np.float64)

SYMBOL_MS = 10                 # 100 sps symbol length
STRING_MS = 2000               # 2 s per string
DATA_MS = 1700
SLOT_MS = 20                   # one relative-code slot (2 symbols)


@dataclasses.dataclass
class GlonassEphemeris:
    """GLONASS broadcast ephemeris (strings 1-4 fields; km/km/s units as
    broadcast, per ephemeris.sci scalings)."""

    # String 1
    tk_h: int = 0
    tk_m: int = 0
    tk_s: int = 0
    x: float = 0.0          # [km]
    xdot: float = 0.0       # [km/s]
    xdotdot: float = 0.0    # [km/s^2]
    # String 2
    Bn: int = 0
    tb: int = 0             # [min within day, multiple of 15]
    y: float = 0.0
    ydot: float = 0.0
    ydotdot: float = 0.0
    # String 3
    gamman: float = 0.0
    z: float = 0.0
    zdot: float = 0.0
    zdotdot: float = 0.0
    # String 4
    taun: float = 0.0
    n: int = 0              # slot number
    valid: bool = False


# ---------------------------------------------------------------------------
# String codec
# ---------------------------------------------------------------------------

def _sm_encode(value: float, scale: float, n_mag: int) -> Tuple[int, List[int]]:
    """Sign-magnitude: returns (sign_bit, magnitude bits list MSB first)."""
    q = int(round(abs(value) / scale))
    q = min(q, (1 << n_mag) - 1)
    return (1 if value < 0 else 0,
            [(q >> (n_mag - 1 - i)) & 1 for i in range(n_mag)])


def _string_bits(eph: GlonassEphemeris, str_num: int) -> np.ndarray:
    """ICD bit array b[85..1] -> numpy [85] with index i = ICD bit (85-i).

    We store as b01[i] for i in 0..84 where b01[0] is ICD bit 85 (first
    transmitted, always 0) and b01[84] is ICD bit 1 (last).
    """
    bits = np.zeros(85, np.int8)

    def put(icd_hi: int, icd_lo: int, value_bits: Sequence[int]):
        # ICD bit numbers descend with time: bit 85 first. b01 index of
        # ICD bit k is 85 - k.
        ks = range(icd_hi, icd_lo - 1, -1)
        for k, v in zip(ks, value_bits):
            bits[85 - k] = v

    def put_uint(icd_hi, icd_lo, value):
        n = icd_hi - icd_lo + 1
        put(icd_hi, icd_lo, [(int(value) >> (n - 1 - i)) & 1
                             for i in range(n)])

    put_uint(84, 81, str_num)
    if str_num == 1:
        put_uint(76, 72, eph.tk_h)
        put_uint(71, 66, eph.tk_m)
        put_uint(65, 65, eph.tk_s // 30)
        s, m = _sm_encode(eph.xdot, 2.0 ** -20, 23)
        put_uint(64, 64, s)
        put(63, 41, m)
        s, m = _sm_encode(eph.xdotdot, 2.0 ** -30, 4)
        put_uint(40, 40, s)
        put(39, 36, m)
        s, m = _sm_encode(eph.x, 2.0 ** -11, 26)
        put_uint(35, 35, s)
        put(34, 9, m)
    elif str_num == 2:
        put_uint(80, 78, (eph.Bn // 4) << 2)   # only MSB of Bn used
        put_uint(76, 70, eph.tb // 15)
        s, m = _sm_encode(eph.ydot, 2.0 ** -20, 23)
        put_uint(64, 64, s)
        put(63, 41, m)
        s, m = _sm_encode(eph.ydotdot, 2.0 ** -30, 4)
        put_uint(40, 40, s)
        put(39, 36, m)
        s, m = _sm_encode(eph.y, 2.0 ** -11, 26)
        put_uint(35, 35, s)
        put(34, 9, m)
    elif str_num == 3:
        s, m = _sm_encode(eph.gamman, 2.0 ** -40, 10)
        put_uint(79, 79, s)
        put(78, 69, m)
        s, m = _sm_encode(eph.zdot, 2.0 ** -20, 23)
        put_uint(64, 64, s)
        put(63, 41, m)
        s, m = _sm_encode(eph.zdotdot, 2.0 ** -30, 4)
        put_uint(40, 40, s)
        put(39, 36, m)
        s, m = _sm_encode(eph.z, 2.0 ** -11, 26)
        put_uint(35, 35, s)
        put(34, 9, m)
    elif str_num == 4:
        s, m = _sm_encode(eph.taun, 2.0 ** -30, 21)
        put_uint(80, 80, s)
        put(79, 59, m)
        put_uint(15, 11, eph.n)
    _kx_set_check_bits(bits)
    return bits


# ---------------------------------------------------------------------------
# KX Hamming code (ICD GLONASS L1/L2 ed. 5.1, section 4.7 + Table 4.13 —
# the ICD the reference ships at GLONASS/ICD/en/ICD_GLONASS_L1_L2_5_1_en.PDF):
# 77 data bits b85..b9 protected by 8 check bits beta8..beta1 (ICD bits
# 8..1); corrects any single-bit error, detects multiple errors.
# ---------------------------------------------------------------------------

def _kx_data_sets():
    """ICD Table 4.13 data-bit index sets for checksums C1..C7."""
    c1 = [9, 10, 12, 13, 15, 17, 19, 20, 22, 24, 26, 28, 30, 32, 34, 35,
          37, 39, 41, 43, 45, 47, 49, 51, 53, 55, 57, 59, 61, 63, 65, 66,
          68, 70, 72, 74, 76, 78, 80, 82, 84]
    c2 = [9, 11, 12, 14, 15, 18, 19, 21, 22, 25, 26, 29, 30, 33, 34, 36,
          37, 40, 41, 44, 45, 48, 49, 52, 53, 56, 57, 60, 61, 64, 65, 67,
          68, 71, 72, 75, 76, 79, 80, 83, 84]
    c3 = (list(range(10, 13)) + list(range(16, 20)) + list(range(23, 27))
          + list(range(31, 35)) + list(range(38, 42))
          + list(range(46, 50)) + list(range(54, 58))
          + list(range(62, 66)) + list(range(69, 73))
          + list(range(77, 81)) + [85])
    c4 = (list(range(13, 20)) + list(range(27, 35)) + list(range(42, 50))
          + list(range(58, 66)) + list(range(73, 81)))
    c5 = (list(range(20, 35)) + list(range(50, 66)) + list(range(81, 86)))
    c6 = list(range(35, 66))
    c7 = list(range(66, 86))
    return [c1, c2, c3, c4, c5, c6, c7]


_KX_SETS = _kx_data_sets()


def _kx_checksums(bits: np.ndarray):
    """(C[7], C_sigma) per Table 4.13 over a b01 array (index 85-icd)."""
    c = []
    for i, idxs in enumerate(_KX_SETS):
        s = int(bits[85 - (i + 1)])            # beta_i = ICD bit i+1
        for k in idxs:
            s ^= int(bits[85 - k])
        c.append(s)
    csum = 0
    for k in range(1, 86):
        csum ^= int(bits[85 - k])
    return c, csum


def _kx_set_check_bits(bits: np.ndarray) -> None:
    """Fill ICD bits 8..1 so all checksums C1..C7 and C_sigma are zero."""
    for i in range(7):
        bits[85 - (i + 1)] = 0
    bits[85 - 8] = 0
    c, _ = _kx_checksums(bits)
    for i in range(7):
        bits[85 - (i + 1)] = c[i]
    _, csum = _kx_checksums(bits)
    bits[85 - 8] = csum


def kx_verify(bits: np.ndarray):
    """ICD 4.7 verification: returns the (possibly single-bit-corrected)
    string, or None if multiple errors are detected (string erased).

    Rules: all checksums zero -> correct; exactly one of C1..C7 = 1 with
    C_sigma = 1 -> error in a check bit (data intact); >= 2 of C1..C7
    with C_sigma = 1 -> correct data bit icor = bin(C7..C1) + 8 - K
    (K = most significant nonzero checksum index); otherwise erase.
    """
    c, csum = _kx_checksums(bits)
    ones = [i + 1 for i in range(7) if c[i]]
    if not ones and csum == 0:
        return bits
    if csum == 1:
        if len(ones) == 1:
            return bits                       # check-bit error only
        if len(ones) >= 2:
            val = 0
            for i in range(6, -1, -1):
                val = (val << 1) | c[i]
            K = max(ones)
            icor = val + 8 - K
            if 9 <= icor <= 85:
                out = bits.copy()
                out[85 - icor] ^= 1
                return out
    return None


def encode_string(bits85: np.ndarray, last_level: float = 1.0) -> np.ndarray:
    """One 2 s string as ±1 symbols [200] at 10 ms.

    bits85: [85] 0/1, index 0 = ICD bit 85 (transmitted first; must be 0).
    Data slots use relative code seeded by +1, each slot split into two
    meander halves (decode_gl_data.sci conventions); then the time mark.
    """
    levels = np.empty(85)
    levels[0] = 1.0
    for j in range(84):
        # decode: bit(ICD 84-j+...) = -nd[j]*nd[j+1]  (1-based j);
        # b01[j+1] corresponds to the bit recovered from slots j, j+1.
        b = bits85[j + 1]
        levels[j + 1] = -levels[j] if b else levels[j]
    sym = np.empty(200)
    # Meander: decode multiplies slot halves by (-1, +1); encode matches.
    sym[0:170:2] = -levels
    sym[1:170:2] = levels
    sym[170:] = TIME_MARK_PM1
    return sym


def encode_strings(eph: GlonassEphemeris, n_strings: int = 15) -> np.ndarray:
    """±1 symbol stream (10 ms symbols) for strings 1..n cycling 1..15."""
    out = []
    for i in range(n_strings):
        sn = i % 15 + 1
        out.append(encode_string(_string_bits(eph, sn)))
    return np.concatenate(out)


def decode_string(prompt_ms: np.ndarray) -> Optional[np.ndarray]:
    """Decode one string's 1700 ms of prompt-I into b01[85] (or None).

    Mirrors decode_gl_data.sci: meander wipeoff, 20 ms sums, differential
    product. Returns array indexed like _string_bits (index 0 = ICD 85).
    """
    x = np.asarray(prompt_ms[:DATA_MS], np.float64)
    meander = np.empty(DATA_MS)
    m = np.ones(170)
    m[1::2] = -1
    meander[:] = np.repeat(-m, SYMBOL_MS)
    nd = (x * meander).reshape(85, SLOT_MS).sum(axis=1)
    if np.any(nd == 0.0):
        return None
    nd = np.sign(nd)
    b = np.zeros(85, np.int8)
    prod = -nd[:-1] * nd[1:]
    b[1:] = ((prod + 1) // 2).astype(np.int8)
    # KX Hamming verification (ICD 4.7): corrects a single bit error
    # (e.g. one flipped symbol from a Costas half-cycle slip — the
    # differential decode turns a polarity flip into exactly one bad
    # bit) and erases multi-error strings instead of silently feeding
    # corrupted fields into the ephemeris.
    return kx_verify(b)


def find_time_mark(prompt_i: np.ndarray) -> int:
    """ms index where the first time mark STARTS, or -1.

    findTimeMarks.sci: correlate the ±10 ms-upsampled TM against prompt
    signs; |corr| > 290 of 300 possible.
    """
    s = np.sign(np.asarray(prompt_i, np.float64))
    tm = np.repeat(TIME_MARK_PM1, SYMBOL_MS)
    if len(s) < len(tm):
        return -1
    corr = np.correlate(s, tm, mode="valid")
    idx = np.nonzero(np.abs(corr) > 290.0)[0]
    return int(idx[0]) if len(idx) else -1


def _sm(bits: np.ndarray, icd_hi: int, icd_lo: int, sign_icd: int,
        scale: float) -> float:
    v = 0
    for k in range(icd_hi, icd_lo - 1, -1):
        v = (v << 1) | int(bits[85 - k])
    return v * scale * (-1.0 if bits[85 - sign_icd] else 1.0)


def _uint(bits: np.ndarray, icd_hi: int, icd_lo: int) -> int:
    v = 0
    for k in range(icd_hi, icd_lo - 1, -1):
        v = (v << 1) | int(bits[85 - k])
    return v


def decode_strings(prompt_i: np.ndarray, data_start_ms: int,
                   n_strings: int = 15
                   ) -> Tuple[GlonassEphemeris, Optional[float]]:
    """Decode ephemeris from consecutive strings.

    data_start_ms: ms index of the first string's DATA start (= time-mark
    start + 300 ms, postNavigation.sci:97).
    Returns (eph, t) with t = frame-referenced time of the first string
    start (ephemeris.sci:95-97: tk - (string1pos-1)*2 - 0.3).
    """
    eph = GlonassEphemeris()
    got = set()
    string_1_pos = None
    for i in range(n_strings):
        seg = prompt_i[data_start_ms + i * STRING_MS:
                       data_start_ms + i * STRING_MS + DATA_MS]
        if len(seg) < DATA_MS:
            break
        b = decode_string(seg)
        if b is None:
            continue
        sn = _uint(b, 84, 81)
        if sn == 1:
            eph.tk_h = _uint(b, 76, 72)
            eph.tk_m = _uint(b, 71, 66)
            eph.tk_s = _uint(b, 65, 65) * 30
            eph.xdot = _sm(b, 63, 41, 64, 2.0 ** -20)
            eph.xdotdot = _sm(b, 39, 36, 40, 2.0 ** -30)
            eph.x = _sm(b, 34, 9, 35, 2.0 ** -11)
            if string_1_pos is None:
                string_1_pos = i + 1
            got.add(1)
        elif sn == 2:
            eph.Bn = (_uint(b, 80, 80)) * 4
            eph.tb = _uint(b, 76, 70) * 15
            eph.ydot = _sm(b, 63, 41, 64, 2.0 ** -20)
            eph.ydotdot = _sm(b, 39, 36, 40, 2.0 ** -30)
            eph.y = _sm(b, 34, 9, 35, 2.0 ** -11)
            got.add(2)
        elif sn == 3:
            eph.gamman = _sm(b, 78, 69, 79, 2.0 ** -40)
            eph.zdot = _sm(b, 63, 41, 64, 2.0 ** -20)
            eph.zdotdot = _sm(b, 39, 36, 40, 2.0 ** -30)
            eph.z = _sm(b, 34, 9, 35, 2.0 ** -11)
            got.add(3)
        elif sn == 4:
            eph.taun = _sm(b, 79, 59, 80, 2.0 ** -30)
            eph.n = _uint(b, 15, 11)
            got.add(4)
    eph.valid = got >= {1, 2, 3, 4}
    t = None
    if eph.valid and string_1_pos is not None:
        t = (eph.tk_h * 3600 + eph.tk_m * 60 + eph.tk_s
             - (string_1_pos - 1) * 2 - 0.3)
    return eph, t


# ---------------------------------------------------------------------------
# PZ-90 orbit propagation (satposg.sci)
# ---------------------------------------------------------------------------

MU = 398600.44e9
C20 = -1082.63e-6
AE = 6378.136e3
WE = 0.7292115e-4


def _accel(p: np.ndarray, v: np.ndarray, acc_ls: np.ndarray) -> np.ndarray:
    """PZ-90 ECEF acceleration with J2 + centrifugal/Coriolis + lunisolar."""
    r2 = np.sum(p * p, axis=-1, keepdims=True)
    r = np.sqrt(r2)
    z2_r2 = (p[..., 2:3] ** 2) / r2
    j2 = 1.5 * C20 * MU * AE ** 2 / r ** 5
    a = -MU / r ** 3 * p + j2 * p * (np.stack(
        [1 - 5 * z2_r2[..., 0], 1 - 5 * z2_r2[..., 0],
         3 - 5 * z2_r2[..., 0]], axis=-1))
    a[..., 0] += WE ** 2 * p[..., 0] + 2 * WE * v[..., 1]
    a[..., 1] += WE ** 2 * p[..., 1] - 2 * WE * v[..., 0]
    return a + acc_ls


def quantize_eph(eph: GlonassEphemeris) -> GlonassEphemeris:
    """Round every broadcast field to its ICD string quantization (the
    same scalings _string_bits encodes with), so simulation truth and the
    decoded ephemeris agree bit-exactly (fixture-by-construction)."""
    def q(v, scale, n_mag):
        m = min(int(round(abs(v) / scale)), (1 << n_mag) - 1)
        return np.copysign(m * scale, v)

    return dataclasses.replace(
        eph,
        x=q(eph.x, 2.0 ** -11, 26), y=q(eph.y, 2.0 ** -11, 26),
        z=q(eph.z, 2.0 ** -11, 26),
        xdot=q(eph.xdot, 2.0 ** -20, 23), ydot=q(eph.ydot, 2.0 ** -20, 23),
        zdot=q(eph.zdot, 2.0 ** -20, 23),
        xdotdot=q(eph.xdotdot, 2.0 ** -30, 4),
        ydotdot=q(eph.ydotdot, 2.0 ** -30, 4),
        zdotdot=q(eph.zdotdot, 2.0 ** -30, 4),
        gamman=q(eph.gamman, 2.0 ** -40, 10),
        taun=q(eph.taun, 2.0 ** -30, 21),
    )


def satpos_gl(transmit_time, ephs: Sequence[GlonassEphemeris]
              ) -> Tuple[np.ndarray, np.ndarray]:
    """pvt.navigate satpos_fn adapter: (pos [S,3] m, clk [S] s)."""
    p, _, c = satposg(transmit_time, ephs)
    return p, c


def satpos_vel_gl(transmit_time, ephs: Sequence[GlonassEphemeris]
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """pvt.navigate satvel_fn adapter: (pos, vel, clk); the RK4 state
    carries velocity directly (satposg.sci integrates both)."""
    return satposg(transmit_time, ephs)


def satposg(transmit_time, ephs: Sequence[GlonassEphemeris]
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PZ-90 positions/velocities + clock corrections at transmit times.

    transmit_time: scalar or [S] seconds within day (same frame as tb).
    Returns (pos [S,3] m, vel [S,3] m/s, clk [S] s). RK4 with 10 s steps
    then 1 s then the sub-second remainder (satposg.sci:66+ structure).
    """
    S = len(ephs)
    tt = np.broadcast_to(np.asarray(transmit_time, np.float64), (S,)).copy()
    pos = np.empty((S, 3))
    vel = np.empty((S, 3))
    clk = np.empty(S)
    for i, e in enumerate(ephs):
        t0 = e.tb * 60.0
        dt = tt[i] - t0
        clk[i] = e.taun - e.gamman * dt
        p = np.array([e.x, e.y, e.z]) * 1000.0
        v = np.array([e.xdot, e.ydot, e.zdot]) * 1000.0
        als = np.array([e.xdotdot, e.ydotdot, e.zdotdot]) * 1000.0
        sgn = 1.0 if dt >= 0 else -1.0
        remaining = abs(dt)
        for h_step in (10.0, 1.0, None):
            if h_step is None:
                steps, h = (1, remaining * sgn) if remaining > 1e-12 \
                    else (0, 0.0)
            else:
                steps = int(remaining // h_step)
                h = h_step * sgn
                remaining -= steps * h_step
            for _ in range(steps):
                k1p = v
                k1v = _accel(p, v, als)
                k2p = v + 0.5 * h * k1v
                k2v = _accel(p + 0.5 * h * k1p, v + 0.5 * h * k1v, als)
                k3p = v + 0.5 * h * k2v
                k3v = _accel(p + 0.5 * h * k2p, v + 0.5 * h * k2v, als)
                k4p = v + h * k3v
                k4v = _accel(p + h * k3p, v + h * k3v, als)
                p = p + h / 6.0 * (k1p + 2 * k2p + 2 * k3p + k4p)
                v = v + h / 6.0 * (k1v + 2 * k2v + 2 * k3v + k4v)
        pos[i] = p
        vel[i] = v
    return pos, vel, clk
