"""GPS LNAV encoder: a frozen copy of the encoder half of the port's
nav/lnav.py (Hamming(32,26) parity with the D29*/D30* chain, TLM + HOW,
subframes 1-3 from the ephemeris, zero pages in 4 and 5).
"""

from __future__ import annotations

import numpy as np

from portbench.gen.orbit import Ephemeris

PREAMBLE = np.array([1, 0, 0, 0, 1, 0, 1, 1], np.int8)
_PARITY_TAPS = (
    (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23),
    (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24),
    (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22),
    (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23),
    (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24),
    (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24),
)
_PARITY_SEED = (0, 1, 0, 1, 1, 0)


def compute_parity(d29s: int, d30s: int, data24) -> np.ndarray:
    seeds = (d29s, d30s)
    out = np.empty(6, np.int8)
    for i, taps in enumerate(_PARITY_TAPS):
        p = seeds[_PARITY_SEED[i]]
        for t in taps:
            p ^= int(data24[t - 1])
        out[i] = p
    return out


def encode_word(data24, d29s: int, d30s: int) -> np.ndarray:
    tx = np.empty(30, np.int8)
    tx[:24] = np.asarray(data24, np.int8) ^ d30s
    tx[24:] = compute_parity(d29s, d30s, np.asarray(data24, np.int8))
    return tx


def _bits(value: int, n: int) -> np.ndarray:
    value = int(value) & ((1 << n) - 1)
    return np.array([(value >> (n - 1 - i)) & 1 for i in range(n)], np.int8)


def _q(value: float, scale: float, n: int) -> int:
    return int(round(value / scale)) & ((1 << n) - 1)


def _subframe_words(eph: Ephemeris, sf_id: int) -> list:
    w = []
    if sf_id == 1:
        iodc = int(eph.IODC) & 0x3FF
        w.append(np.concatenate([
            _bits(eph.week, 10), _bits(1, 2), _bits(eph.accuracy, 4),
            _bits(eph.health, 6), _bits(iodc >> 8, 2)]))
        w += [_bits(0, 24)] * 3
        w.append(np.concatenate([
            _bits(0, 16), _bits(_q(eph.T_GD, 2.0 ** -31, 8), 8)]))
        w.append(np.concatenate([
            _bits(iodc & 0xFF, 8), _bits(int(eph.t_oc) >> 4, 16)]))
        w.append(np.concatenate([
            _bits(_q(eph.a_f2, 2.0 ** -55, 8), 8),
            _bits(_q(eph.a_f1, 2.0 ** -43, 16), 16)]))
        w.append(np.concatenate([
            _bits(_q(eph.a_f0, 2.0 ** -31, 22), 22), _bits(0, 2)]))
    elif sf_id == 2:
        m0 = _q(eph.M_0 / np.pi, 2.0 ** -31, 32)
        ecc = _q(eph.e, 2.0 ** -33, 32)
        sqa = _q(eph.sqrtA, 2.0 ** -19, 32)
        w.append(np.concatenate([
            _bits(eph.IODE_sf2, 8), _bits(_q(eph.C_rs, 2.0 ** -5, 16), 16)]))
        w.append(np.concatenate([
            _bits(_q(eph.deltan / np.pi, 2.0 ** -43, 16), 16),
            _bits(m0 >> 24, 8)]))
        w.append(_bits(m0 & 0xFFFFFF, 24))
        w.append(np.concatenate([
            _bits(_q(eph.C_uc, 2.0 ** -29, 16), 16), _bits(ecc >> 24, 8)]))
        w.append(_bits(ecc & 0xFFFFFF, 24))
        w.append(np.concatenate([
            _bits(_q(eph.C_us, 2.0 ** -29, 16), 16), _bits(sqa >> 24, 8)]))
        w.append(_bits(sqa & 0xFFFFFF, 24))
        w.append(np.concatenate([
            _bits(int(eph.t_oe) >> 4, 16), _bits(0, 1), _bits(0, 5),
            _bits(0, 2)]))
    elif sf_id == 3:
        om0 = _q(eph.omega_0 / np.pi, 2.0 ** -31, 32)
        i0 = _q(eph.i_0 / np.pi, 2.0 ** -31, 32)
        om = _q(eph.omega / np.pi, 2.0 ** -31, 32)
        w.append(np.concatenate([
            _bits(_q(eph.C_ic, 2.0 ** -29, 16), 16), _bits(om0 >> 24, 8)]))
        w.append(_bits(om0 & 0xFFFFFF, 24))
        w.append(np.concatenate([
            _bits(_q(eph.C_is, 2.0 ** -29, 16), 16), _bits(i0 >> 24, 8)]))
        w.append(_bits(i0 & 0xFFFFFF, 24))
        w.append(np.concatenate([
            _bits(_q(eph.C_rc, 2.0 ** -5, 16), 16), _bits(om >> 24, 8)]))
        w.append(_bits(om & 0xFFFFFF, 24))
        w.append(_bits(_q(eph.omegaDot / np.pi, 2.0 ** -43, 24), 24))
        w.append(np.concatenate([
            _bits(eph.IODE_sf3, 8),
            _bits(_q(eph.iDot / np.pi, 2.0 ** -43, 14), 14), _bits(0, 2)]))
    else:
        w = [_bits(0, 24) for _ in range(8)]
    return w


def encode_subframe(eph: Ephemeris, sf_id: int, tow_next: int, d29s: int,
                    d30s: int) -> tuple:
    """One 300-bit subframe; tow_next is the HOW's truncated TOW of the
    next subframe. Returns (bits[300], d29s, d30s)."""
    words = []
    tx = encode_word(np.concatenate([PREAMBLE, _bits(0, 14), _bits(0, 2)]),
                     d29s, d30s)
    words.append(tx)
    d29s, d30s = int(tx[28]), int(tx[29])
    for t1 in (0, 1):
        for t2 in (0, 1):
            how = np.concatenate([
                _bits(tow_next, 17), _bits(0, 2), _bits(sf_id, 3),
                np.array([t1, t2], np.int8)])
            tx = encode_word(how, d29s, d30s)
            if tx[28] == 0 and tx[29] == 0:
                break
        else:
            continue
        break
    words.append(tx)
    d29s, d30s = int(tx[28]), int(tx[29])
    for data in _subframe_words(eph, sf_id):
        tx = encode_word(data, d29s, d30s)
        words.append(tx)
        d29s, d30s = int(tx[28]), int(tx[29])
    return np.concatenate(words), d29s, d30s


def encode_frames(eph: Ephemeris, tow0: int = 0, n_subframes: int = 5,
                  first_sf: int = 1) -> np.ndarray:
    """Subframes cycling 1..5 from truncated TOW tow0 (6 s units), as +-1
    (bit 1 -> -1), length 300 * n_subframes."""
    d29s = d30s = 0
    bits = []
    sf = first_sf
    for k in range(n_subframes):
        sfbits, d29s, d30s = encode_subframe(eph, sf, (tow0 + k + 1) % 100800,
                                             d29s, d30s)
        bits.append(sfbits)
        sf = sf % 5 + 1
    return 1.0 - 2.0 * np.concatenate(bits).astype(np.float64)
