"""GPS LNAV message: parity, encoder (fixture generation), decoder.

Reference semantics reproduced:
  - Hamming(32,26) parity check: GPS/L1/include/navPartyChk.sci (reference
    POSTPROCESSING_SCILAB_RECEIVERS/GPS/L1/include/navPartyChk.sci) and the
    C++ twin Channel::ParityCheck (objects/channel.cpp:784-817).
  - Polarity recovery via D30*: GPS/L1/include/checkPhase.sci.
  - Subframe/ephemeris field extraction: GPS/L1/include/ephemeris.sci:71-228
    and objects/ephemeris.cpp:350-424.

The encoder has no counterpart in the reference receivers (the simulator
there generates GLONASS L3 only); it exists so closed-loop tests can be
fixture-by-construction like glonass_l3_generator.sce, but with decodable
GPS LNAV frames: encode(eph) -> track -> decode(bits) must round-trip
bit-exactly.

All of this layer is host-side NumPy: nav decode is scalar and branchy —
the wrong shape for the MXU (SURVEY.md L4: "everything from findPreambles
down stays host-side").

Copied from gnsstpu/nav/lnav.py; only the import prefix differs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from gnsstpu_torch.nav.types import Ephemeris

PREAMBLE = np.array([1, 0, 0, 0, 1, 0, 1, 1], np.int8)  # 0x8B

# Parity-equation tap tables: for each of D25..D30, the 1-based indices of
# the 24 source data bits XORed in (IS-GPS-200 Table 20-XIV).
_PARITY_TAPS = (
    (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23),
    (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24),
    (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22),
    (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23),
    (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24),
    (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24),
)
# Which of (D29*, D30*) seeds each parity bit: index 0 -> D29*, 1 -> D30*.
_PARITY_SEED = (0, 1, 0, 1, 1, 0)


def compute_parity(d29s: int, d30s: int, data24: np.ndarray) -> np.ndarray:
    """Parity bits D25..D30 for 24 *source* data bits (already decoded,
    i.e. not XORed with D30*)."""
    seeds = (d29s, d30s)
    out = np.empty(6, np.int8)
    for i, taps in enumerate(_PARITY_TAPS):
        p = seeds[_PARITY_SEED[i]]
        for t in taps:
            p ^= int(data24[t - 1])
        out[i] = p
    return out


def parity_ok(word32: np.ndarray) -> bool:
    """Check one 32-bit unit: [D29*, D30*, d1..d30] of *transmitted* bits.

    Mirrors navPartyChk.sci: first undo the D30* inversion of the 24 data
    bits, then recompute D25..D30 and compare.
    """
    w = np.asarray(word32, np.int8)
    d29s, d30s = int(w[0]), int(w[1])
    data = w[2:26] ^ d30s
    par = compute_parity(d29s, d30s, data)
    return bool(np.all(par == w[26:32]))


def encode_word(data24: np.ndarray, d29s: int, d30s: int) -> np.ndarray:
    """Source 24 bits + previous parity -> 30 transmitted bits."""
    par = compute_parity(d29s, d30s, np.asarray(data24, np.int8))
    tx = np.empty(30, np.int8)
    tx[:24] = np.asarray(data24, np.int8) ^ d30s
    tx[24:] = par
    return tx


def _bits(value: int, n: int) -> np.ndarray:
    """n-bit big-endian unsigned bit array of value (masked to n bits)."""
    value = int(value) & ((1 << n) - 1)
    return np.array([(value >> (n - 1 - i)) & 1 for i in range(n)], np.int8)


def _unsigned(bits: np.ndarray) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def _signed(bits: np.ndarray) -> int:
    v = _unsigned(bits)
    n = len(bits)
    return v - (1 << n) if v >= (1 << (n - 1)) else v


def _q(value: float, scale: float, n: int) -> int:
    """Quantize value to an n-bit two's-complement integer of given scale."""
    return int(round(value / scale)) & ((1 << n) - 1)


# ---------------------------------------------------------------------------
# Encoder (fixture generation)
# ---------------------------------------------------------------------------

def _subframe_words(eph: Ephemeris, sf_id: int) -> List[np.ndarray]:
    """Source 24-bit data for words 3..10 of subframe sf_id (1..3)."""
    w = []
    if sf_id == 1:
        iodc = int(eph.IODC) & 0x3FF
        w.append(np.concatenate([
            _bits(eph.week, 10), _bits(1, 2),             # WN, code-on-L2=P
            _bits(eph.accuracy, 4), _bits(eph.health, 6),
            _bits(iodc >> 8, 2)]))                        # IODC MSBs
        w.append(_bits(0, 24))                            # word 4 (L2P flag+rsvd)
        w.append(_bits(0, 24))                            # word 5 reserved
        w.append(_bits(0, 24))                            # word 6 reserved
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
    else:  # subframes 4/5: almanac pages — emit zeros (valid parity, no eph)
        w = [_bits(0, 24) for _ in range(8)]
    return w


def encode_subframe(eph: Ephemeris, sf_id: int, tow_next: int,
                    d29s: int, d30s: int,
                    page_words: Optional[List[np.ndarray]] = None
                    ) -> Tuple[np.ndarray, int, int]:
    """Encode one 300-bit subframe.

    tow_next: 17-bit truncated TOW (units of 6 s) of the *next* subframe
    start, as carried in the HOW (ephemeris.sci TOW convention).
    page_words: optional 8 x 24-bit source words for words 3..10
    (subframe 4/5 almanac/iono pages, see nav.almanac); default content
    comes from `eph` per sf_id.
    Returns (bits[300], d29s, d30s) with the parity chain carried through.
    """
    words: List[np.ndarray] = []
    # Word 1: TLM — preamble + 14-bit message + 2 reserved.
    tlm = np.concatenate([PREAMBLE, _bits(0, 14), _bits(0, 2)])
    tx = encode_word(tlm, d29s, d30s)
    words.append(tx)
    d29s, d30s = int(tx[28]), int(tx[29])
    # Word 2: HOW — 17-bit TOW, alert=0, AS=0, subframe id, 2 bits chosen so
    # that D29=D30=0 (IS-GPS-200 20.3.3.2; makes next word's seed (0,0)).
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
    for data in (page_words if page_words is not None
                 else _subframe_words(eph, sf_id)):
        tx = encode_word(data, d29s, d30s)
        words.append(tx)
        d29s, d30s = int(tx[28]), int(tx[29])
    return np.concatenate(words), d29s, d30s


def encode_frames(eph: Ephemeris, tow0: int = 0, n_subframes: int = 5,
                  first_sf: int = 1,
                  pages: Optional[List[List[np.ndarray]]] = None
                  ) -> np.ndarray:
    """Encode a stream of subframes cycling 1..5, as ±1 bits.

    tow0: truncated TOW (6 s units) of the start of the first subframe.
    pages: optional subframe-4/5 content — a list of 8×24-bit word sets
    (nav.almanac.almanac_page_words / iono_utc_page_words) consumed
    cyclically each time a subframe 4 or 5 comes up (the broadcast
    almanac rotation); default 4/5 content is zero pages.
    Returns float array of ±1, length 300*n_subframes.
    """
    d29s = d30s = 0
    bits = []
    sf = first_sf
    page_i = 0
    for k in range(n_subframes):
        tow_next = (tow0 + k + 1) % 100800
        pw = None
        if pages and sf in (4, 5):
            pw = pages[page_i % len(pages)]
            page_i += 1
        sfbits, d29s, d30s = encode_subframe(eph, sf, tow_next, d29s,
                                             d30s, page_words=pw)
        bits.append(sfbits)
        sf = sf % 5 + 1
    b = np.concatenate(bits).astype(np.float64)
    return 1.0 - 2.0 * b  # bit 1 -> -1 (BPSK)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def checked_subframes(bits01: np.ndarray, d30_star: int = 0,
                      d29_star: int = 0):
    """Parity-checked subframe walk shared by the ephemeris and the
    almanac/page decoders.

    Yields (subframe_index, sf_id, tow_next6, d[192]) for every subframe
    whose 10 words all pass Hamming(32,26) parity with the D29*/D30*
    chain carried across words (ephemeris.sci / navPartyChk semantics);
    d holds the polarity-corrected source bits of words 3..10.
    """
    b = np.asarray(bits01, np.int8)
    n_sf = len(b) // 300
    d29s, d30s = int(d29_star), int(d30_star)
    for s in range(n_sf):
        sf = b[s * 300:(s + 1) * 300]
        words = []
        ok = True
        for wi in range(10):
            w30 = sf[wi * 30:(wi + 1) * 30]
            unit = np.concatenate([[d29s, d30s], w30])
            if not parity_ok(unit):
                ok = False
                break
            words.append(w30[:24] ^ d30s)   # decoded source bits
            d29s, d30s = int(w30[28]), int(w30[29])
        if not ok:
            # Re-sync assumption broken; skip this subframe.
            d29s, d30s = int(sf[-2]), int(sf[-1])
            continue
        how = words[1]
        sf_id = _unsigned(how[19:22])
        tow_next6 = _unsigned(how[:17])
        yield s, sf_id, tow_next6, np.concatenate(words[2:])


def decode_subframes(bits01: np.ndarray, d30_star: int = 0,
                     d29_star: int = 0
                     ) -> Tuple[Ephemeris, Optional[int]]:
    """Decode ephemeris from >=5 consecutive subframes of 0/1 bits.

    bits01 must start at a subframe boundary (preamble first bit); the two
    bits before it give d30_star for the first word's polarity (pass the
    value or 0 if the stream starts cold — the TLM word then self-corrects
    via parity failure... the reference instead always has 2 spare bits,
    findPreambles.sci:62 subtracts 40ms; here we accept d30_star directly).

    Returns (Ephemeris, TOW-of-first-subframe-start in seconds) following
    ephemeris.sci:71-228 conventions (angles in semicircles scaled to rad).
    """
    eph = Ephemeris()
    tow_s: Optional[int] = None
    got = set()
    for s, sf_id, tow_next6, d in checked_subframes(
            bits01, d30_star, d29_star):
        if tow_s is None:
            # TOW in HOW is for the NEXT subframe; first subframe start =
            # (tow_next - 1) * 6 - s*6 ... relative to stream start.
            tow_s = ((tow_next6 - 1 - s) % 100800) * 6
        pi = np.pi
        if sf_id == 1:
            eph.week = _unsigned(d[0:10])
            eph.accuracy = _unsigned(d[12:16])
            eph.health = _unsigned(d[16:22])
            eph.IODC = (_unsigned(d[22:24]) << 8) | _unsigned(d[120:128])
            eph.T_GD = _signed(d[112:120]) * 2.0 ** -31
            eph.t_oc = _unsigned(d[128:144]) * 2.0 ** 4
            eph.a_f2 = _signed(d[144:152]) * 2.0 ** -55
            eph.a_f1 = _signed(d[152:168]) * 2.0 ** -43
            eph.a_f0 = _signed(d[168:190]) * 2.0 ** -31
            got.add(1)
        elif sf_id == 2:
            eph.IODE_sf2 = _unsigned(d[0:8])
            eph.C_rs = _signed(d[8:24]) * 2.0 ** -5
            eph.deltan = _signed(d[24:40]) * 2.0 ** -43 * pi
            eph.M_0 = _signed(np.concatenate([d[40:48], d[48:72]])) \
                * 2.0 ** -31 * pi
            eph.C_uc = _signed(d[72:88]) * 2.0 ** -29
            eph.e = _unsigned(np.concatenate([d[88:96], d[96:120]])) \
                * 2.0 ** -33
            eph.C_us = _signed(d[120:136]) * 2.0 ** -29
            eph.sqrtA = _unsigned(np.concatenate([d[136:144], d[144:168]])) \
                * 2.0 ** -19
            eph.t_oe = _unsigned(d[168:184]) * 2.0 ** 4
            got.add(2)
        elif sf_id == 3:
            eph.C_ic = _signed(d[0:16]) * 2.0 ** -29
            eph.omega_0 = _signed(np.concatenate([d[16:24], d[24:48]])) \
                * 2.0 ** -31 * pi
            eph.C_is = _signed(d[48:64]) * 2.0 ** -29
            eph.i_0 = _signed(np.concatenate([d[64:72], d[72:96]])) \
                * 2.0 ** -31 * pi
            eph.C_rc = _signed(d[96:112]) * 2.0 ** -5
            eph.omega = _signed(np.concatenate([d[112:120], d[120:144]])) \
                * 2.0 ** -31 * pi
            eph.omegaDot = _signed(d[144:168]) * 2.0 ** -43 * pi
            eph.IODE_sf3 = _unsigned(d[168:176])
            eph.iDot = _signed(d[176:190]) * 2.0 ** -43 * pi
            got.add(3)
    eph.valid = got >= {1, 2, 3}
    return eph, tow_s
