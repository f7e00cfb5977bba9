"""Galileo E1B BOC(1,1) with I/NAV: the composite codes, the sky, and the
I/NAV fields a decoder must read. A frozen copy, in NumPy, of the port's
signals/galileo_e1.py composite_code, nav/galileo.py encode_frames and
sim/scenario.py galileo_constellation + build_scenario_galileo.

Codes: the E1B memory codes of the Galileo OS SIS ICD (annex C), read from
galileo_e1_codes.npz beside this file (a byte copy of the port's table,
bit-packed, 0 -> +1 and 1 -> -1), each chip times the BOC(1,1) subcarrier:
8,184 half-chips at 2.046 MHz, one 4 ms code period. E1B only: the E1C
pilot is not in the sky.

Pages (Galileo OS SIS ICD): a nominal page is an even and an odd part of
1 s, each 10 sync symbols and 240 symbols of 114 bits (6 tail bits added),
rate-1/2 K=7 coded and block-interleaved 8 x 30; CRC-24Q over the even
part and the odd part's first 82 bits; word types 1-5 (ephemeris, clock,
ionosphere, GST) in turn, word 5 stamping its page's start with the TOW.
250 symbols a second, one a code period.

Sky: the reference tests' 30 synthetic Keplerian orbits, the n_sats
highest at the drawn start, with the ephemerides as the pages carry them,
2 s of random lead symbols, then pages from the start. The Doppler rate is
the delay's full second derivative (gen/orbit.py fit_delay); the port's
scenario halves it. The seed draws the start within +-start_span_2s pages
of the ephemerides' reference time, the receiver clock's offset (a common
code delay), the carrier phases and the lead symbols.
"""

from __future__ import annotations

import functools
import types
from pathlib import Path

import numpy as np

from portbench.gen import codes
from portbench.gen.lnav import _bits, _q
from portbench.gen.orbit import Ephemeris, fit_delay, satpos, topocent
from portbench.gen.sky import Sat, Signal, Sky
from portbench.reference.truth import broadcast_fields

CODES = Path(__file__).with_name("galileo_e1_codes.npz")
CODE_LENGTH = 4092           # primary chips a 4 ms period
NUM_PRN = 50
CARRIER_HZ = 1575.42e6
#: The ICD's pi for semicircles, GM [m^3/s^2] and Earth rotation [rad/s].
GAL_PI = 3.1415926535898
GAL_GM = 3.986004418e14
GAL_OMEGA_E = 7.2921151467e-5
ORBIT = {"gm": GAL_GM, "omega_e": GAL_OMEGA_E}
#: The true receiver position [ECEF m] and the ephemerides' t_oe [GST s].
RECV_ECEF = np.array([3427947.0, 603774.0, 5326967.0])
TOW0 = 351000

#: I/NAV fields: (scale, bits, signed, semicircles) of the Galileo OS SIS
#: ICD's ephemeris, clock, ionosphere and group-delay parameters.
INAV_FIELDS = {
    "t_oe": (60.0, 14, False, False),
    "M_0": (2.0 ** -31, 32, True, True),
    "e": (2.0 ** -33, 32, False, False),
    "sqrtA": (2.0 ** -19, 32, False, False),
    "omega_0": (2.0 ** -31, 32, True, True),
    "i_0": (2.0 ** -31, 32, True, True),
    "omega": (2.0 ** -31, 32, True, True),
    "iDot": (2.0 ** -43, 14, True, True),
    "omegaDot": (2.0 ** -43, 24, True, True),
    "deltan": (2.0 ** -43, 16, True, True),
    "C_uc": (2.0 ** -29, 16, True, False),
    "C_us": (2.0 ** -29, 16, True, False),
    "C_rc": (2.0 ** -5, 16, True, False),
    "C_rs": (2.0 ** -5, 16, True, False),
    "C_ic": (2.0 ** -29, 16, True, False),
    "C_is": (2.0 ** -29, 16, True, False),
    "t_oc": (60.0, 14, False, False),
    "a_f0": (2.0 ** -34, 31, True, False),
    "a_f1": (2.0 ** -46, 21, True, False),
    "a_f2": (2.0 ** -59, 6, True, False),
    "ai0": (2.0 ** -2, 11, False, False),
    "ai1": (2.0 ** -8, 11, True, False),
    "ai2": (2.0 ** -15, 14, True, False),
    "BGD_E1E5a": (2.0 ** -32, 10, True, False),
    "BGD_E1E5b": (2.0 ** -32, 10, True, False),
}
#: Integer fields and their widths.
INAV_INTS = {"IODnav": 10, "SISA": 8, "SVID": 6, "health_E1B": 2, "WN": 12}
#: Each word type's content after its 6-bit type: field names, spare bit
#: counts, and TOW (20 bits, the page's start).
WORDS = {
    1: ("IODnav", "t_oe", "M_0", "e", "sqrtA", 2),
    2: ("IODnav", "omega_0", "i_0", "omega", "iDot", 2),
    3: ("IODnav", "omegaDot", "deltan", "C_uc", "C_us", "C_rc", "C_rs",
        "SISA"),
    4: ("IODnav", "SVID", "C_ic", "C_is", "t_oc", "a_f0", "a_f1", "a_f2", 2),
    5: ("ai0", "ai1", "ai2", 5, "BGD_E1E5a", "BGD_E1E5b", 2, "health_E1B",
        2, "WN", "TOW", 23),
}
SYNC_PM = (1 - 2 * np.array([0, 1, 0, 1, 1, 0, 0, 0, 0, 0], np.int8)
           ).astype(np.float32)
#: The I/NAV coder: generator polynomials (octal), the second inverted.
INAV_POLYS = (0o171, 0o133)
INAV_INVERT = (False, True)
PAGE_S = 2.0
LEAD_S = 2.0

#: The ephemeris every orbit starts from (reference tests'
#: make_gal_constellation); M_0, omega_0 and i_0 vary by orbit.
BASE = dict(
    IODnav=61, t_oe=351000.0, M_0=0.654321, e=2.5e-4, sqrtA=5440.588,
    omega_0=-1.0471975, i_0=0.9773844, omega=0.5235988,
    iDot=-1.8e-10, omegaDot=-5.6e-9, deltan=3.2e-9,
    C_uc=-8.5e-7, C_us=9.9e-6, C_rc=112.25, C_rs=-27.125,
    SISA=107, SVID=11, C_ic=3.7e-8, C_is=-5.6e-8, t_oc=351000.0,
    a_f0=-1.2e-4, a_f1=-7.9e-12, a_f2=0.0,
    ai0=40.0, ai1=0.15, ai2=0.002, BGD_E1E5a=2.3e-9,
    BGD_E1E5b=2.8e-9, health_E1B=0, WN=1042)


@functools.lru_cache(maxsize=1)
def _primary() -> np.ndarray:
    """+-1 int8 [50, 4092] E1B primary codes."""
    with np.load(CODES) as z:
        bits = np.unpackbits(z["e1b"], axis=1)[:, :CODE_LENGTH]
    return (1 - 2 * bits.astype(np.int8)).astype(np.int8)


def code(prn: int) -> np.ndarray:
    """+-1 int8 [8184] composite E1B code of PRN 1..50 at the half-chip
    rate: chip k // 2 times the subcarrier (+1 on even half-chips)."""
    if not 1 <= prn <= NUM_PRN:
        raise ValueError(f"E1B PRN must be in 1..{NUM_PRN}: {prn}")
    sub = np.ones(2 * CODE_LENGTH, np.int8)
    sub[1::2] = -1
    return (np.repeat(_primary()[prn - 1], 2) * sub).astype(np.int8)


def broadcast(eph) -> dict:
    """{field: value} a decoder must read of one satellite's I/NAV
    words 1-5."""
    return broadcast_fields(eph, INAV_FIELDS, INAV_INTS, pi=GAL_PI)


def _unit(name: str) -> float:
    scale, _, _, semicircles = INAV_FIELDS[name]
    return scale * (GAL_PI if semicircles else 1.0)


def word_bits(eph, wtype: int, tow: int) -> np.ndarray:
    """128-bit I/NAV word: 6 type bits and the word's content."""
    parts = [_bits(wtype, 6)]
    for f in WORDS[wtype]:
        if isinstance(f, int):
            parts.append(_bits(0, f))
        elif f == "TOW":
            parts.append(_bits(tow, 20))
        elif f in INAV_INTS:
            parts.append(_bits(getattr(eph, f), INAV_INTS[f]))
        else:
            n = INAV_FIELDS[f][1]
            parts.append(_bits(_q(getattr(eph, f), _unit(f), n), n))
    return np.concatenate(parts)


def crc24q(bits: np.ndarray) -> int:
    """CRC-24Q (polynomial 0x1864CFB) of 0/1 bits, most significant
    first."""
    reg = 0
    for b in np.asarray(bits, np.int64):
        reg ^= int(b) << 23
        reg <<= 1
        if reg & 0x1000000:
            reg ^= 0x1864CFB
    return reg & 0xFFFFFF


def encode_page_part(bits114: np.ndarray) -> np.ndarray:
    """114 bits -> 250 +-1 symbols: the sync pattern, then the coded
    bits written row by row into 30 x 8 and sent column by column."""
    syms = codes.conv_encode(bits114, polys=INAV_POLYS, invert=INAV_INVERT)
    levels = (1 - 2 * syms.reshape(30, 8).T.reshape(-1)).astype(np.float32)
    return np.concatenate([SYNC_PM, levels])


def encode_page_pair(word128: np.ndarray) -> np.ndarray:
    """One nominal page, 500 +-1 symbols: even part [0, 0, data 1-112],
    odd part [1, 0, data 113-128, 64 zero bits, CRC-24Q, 8 zero bits]."""
    w = np.asarray(word128, np.int8)
    even = np.concatenate([[0, 0], w[:112]]).astype(np.int8)
    odd_head = np.concatenate([[1, 0], w[112:128],
                               np.zeros(64, np.int8)]).astype(np.int8)
    crc = crc24q(np.concatenate([even, odd_head]))
    odd = np.concatenate([odd_head, _bits(crc, 24), np.zeros(8, np.int8)])
    return np.concatenate([encode_page_part(even), encode_page_part(odd)])


def encode_frames(eph, tow0: int, n_pages: int) -> np.ndarray:
    """+-1 symbols of n_pages nominal pages, word types 1-5 in turn from
    GST TOW tow0 (a page every 2 s)."""
    return np.concatenate([
        encode_page_pair(word_bits(eph, k % 5 + 1, tow0 + 2 * k))
        for k in range(n_pages)])


def orbits() -> list:
    """The 30 synthetic Keplerian orbits of the Galileo sky, as
    ephemeris records of I/NAV's fields."""
    out = []
    for k in range(30):
        d = dict(BASE)
        d["M_0"] = (BASE["M_0"] + 2.7 * k) % (2 * np.pi) - np.pi
        d["omega_0"] = (BASE["omega_0"] + 1.7 * k) % (2 * np.pi) - np.pi
        d["i_0"] = 0.95 + 0.03 * (k % 3)
        out.append(types.SimpleNamespace(**d))
    return out


def kepler(eph) -> Ephemeris:
    """The orbit record of an I/NAV ephemeris; BGD(E1, E5b) is the E1
    group delay (OS SIS ICD 5.1.5)."""
    return Ephemeris(
        t_oc=eph.t_oc, a_f0=eph.a_f0, a_f1=eph.a_f1, a_f2=eph.a_f2,
        T_GD=eph.BGD_E1E5b, sqrtA=eph.sqrtA, e=eph.e, M_0=eph.M_0,
        deltan=eph.deltan, omega=eph.omega, omega_0=eph.omega_0,
        omegaDot=eph.omegaDot, i_0=eph.i_0, iDot=eph.iDot, t_oe=eph.t_oe,
        C_uc=eph.C_uc, C_us=eph.C_us, C_rc=eph.C_rc, C_rs=eph.C_rs,
        C_ic=eph.C_ic, C_is=eph.C_is, valid=True)


def sky(sig: Signal, traffic: dict, seed: int) -> Sky:
    """The n_sats highest of the 30 orbits at the drawn start, each with
    its ephemeris as the pages carry it (SVID its PRN), 2 s of random
    lead symbols, then pages from the start, plus the first absent
    PRNs."""
    rng = np.random.default_rng([int(seed), 3])
    p = traffic["sky"]
    tow0 = TOW0 + 2 * int(rng.integers(-p["start_span_2s"],
                                       p["start_span_2s"] + 1))
    clock_bias = float(rng.uniform(0.0, p["clock_bias_max_s"]))
    duration_s = traffic["recording_ms"] * 1e-3 + 1.0
    recv = RECV_ECEF.copy()
    ephs = orbits()
    pos, _ = satpos(float(tow0), [kepler(e) for e in ephs], **ORBIT)
    _, el, _ = topocent(recv, pos - recv)
    order = np.argsort(-el)[: p["n_sats"]]
    n_pages = int(np.ceil((duration_s + PAGE_S) / PAGE_S)) + 1
    period_s = sig.bit_len_codes * sig.code_length / sig.code_freq
    n_lead = int(round(LEAD_S / period_s))
    sats, chosen = [], {}
    for k in sorted(order, key=lambda k: int(k)):
        prn = int(k) + 1
        q = types.SimpleNamespace(**dict(broadcast(ephs[k]), SVID=prn))
        chosen[prn] = q
        orb = kepler(q)
        _, clk = satpos(float(tow0), [orb], **ORBIT)
        tau0, taud, taudd = fit_delay(orb, recv, tow0 - LEAD_S, duration_s,
                                      **ORBIT)
        lead = rng.choice([-1.0, 1.0], size=n_lead)
        sats.append(Sat(
            prn=prn, doppler_hz=-CARRIER_HZ * taud,
            doppler_rate=-CARRIER_HZ * taudd,
            code_phase_chips=(tau0 - float(clk[0]) + clock_bias)
            * sig.code_freq,
            carrier_phase=float(rng.uniform(0, 2 * np.pi)),
            cn0_dbhz=float(p["cn0_dbhz"]),
            nav_bits=np.concatenate([lead,
                                     encode_frames(q, tow0, n_pages)])))
    prns = sorted(chosen)
    absent = [n for n in range(1, NUM_PRN + 1)
              if n not in prns][: p["n_absent"]]
    on_air = LEAD_S + 5 * PAGE_S + max(s.code_phase_chips for s in sats) \
        / sig.code_freq
    return Sky(signal=sig, sats=sats, prns=prns, absent=absent,
               recv_ecef=recv, ephs=chosen, ephemeris_on_air_s=on_air)
