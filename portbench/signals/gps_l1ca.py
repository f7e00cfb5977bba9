"""GPS L1 C/A with LNAV: the C/A codes, the sky, and the LNAV fields a
decoder must read.

The sky is a frozen copy of the port's sim/scenario.py bench_constellation
(the live GPS receiver's geometry-true sky with LNAV frames), its Doppler
rate mended to the delay's second derivative (gen/orbit.py fit_delay). The
seed draws the start time within +-start_span_6s subframes of the
ephemerides' reference time, the receiver clock's offset (a common code
delay), the carrier phases and the filler bits.
"""

from __future__ import annotations

import numpy as np

from portbench.gen import codes, lnav
from portbench.gen.orbit import Ephemeris, fit_delay, satpos, topocent
from portbench.gen.sky import Sat, Signal, Sky
from portbench.reference.truth import broadcast_fields

GPS_CARRIER_HZ = 1575.42e6
#: The true receiver position of the GPS sky [ECEF m].
GPS_RECV_ECEF = np.array([3427947.0, 603774.0, 5326967.0])
#: Truncated TOW (6 s units) of the ephemerides' reference time t_oe.
GPS_TOW0_6S = 44400

#: LNAV fields: (scale, bits, signed, semicircles), IS-GPS-200 table
#: 20-III. Integer fields not listed are carried as they are.
LNAV_FIELDS = {
    "T_GD": (2.0 ** -31, 8, True, False),
    "t_oc": (16.0, 16, False, False),
    "a_f2": (2.0 ** -55, 8, True, False),
    "a_f1": (2.0 ** -43, 16, True, False),
    "a_f0": (2.0 ** -31, 22, True, False),
    "C_rs": (2.0 ** -5, 16, True, False),
    "deltan": (2.0 ** -43, 16, True, True),
    "M_0": (2.0 ** -31, 32, True, True),
    "C_uc": (2.0 ** -29, 16, True, False),
    "e": (2.0 ** -33, 32, False, False),
    "C_us": (2.0 ** -29, 16, True, False),
    "sqrtA": (2.0 ** -19, 32, False, False),
    "t_oe": (16.0, 16, False, False),
    "C_ic": (2.0 ** -29, 16, True, False),
    "omega_0": (2.0 ** -31, 32, True, True),
    "C_is": (2.0 ** -29, 16, True, False),
    "i_0": (2.0 ** -31, 32, True, True),
    "C_rc": (2.0 ** -5, 16, True, False),
    "omega": (2.0 ** -31, 32, True, True),
    "omegaDot": (2.0 ** -43, 24, True, True),
    "iDot": (2.0 ** -43, 14, True, True),
}
LNAV_INTS = ("week", "health", "IODC", "IODE_sf2", "IODE_sf3")


def code(prn: int) -> np.ndarray:
    return codes.ca_code(prn)


def broadcast(eph) -> dict:
    """{field: value} a decoder must read of one satellite's LNAV
    ephemeris."""
    return broadcast_fields(eph, LNAV_FIELDS, LNAV_INTS)


def gps_orbits() -> list:
    """The 24 synthetic Keplerian orbits of the GPS sky."""
    base = dict(
        t_oc=266400.0, a_f0=2.45e-4, a_f1=-3.2e-12, a_f2=0.0,
        T_GD=-4.656e-9, sqrtA=5153.712, e=0.0123456, M_0=1.23456,
        deltan=4.2e-9, omega=-1.87654, omega_0=-2.0312,
        omegaDot=-8.1e-9, i_0=0.96123, iDot=4.0e-10, t_oe=266400.0,
        C_uc=-6.7e-7, C_us=8.1e-6, C_rc=221.5625, C_rs=-12.8125,
        C_ic=-7.45e-8, C_is=1.12e-7, valid=True)
    ephs = []
    for k in range(24):
        d = dict(base)
        d["M_0"] = (base["M_0"] + 2.1 * k) % (2 * np.pi) - np.pi
        d["omega_0"] = (base["omega_0"] + 1.1 * k) % (2 * np.pi) - np.pi
        d["i_0"] = 0.93 + 0.03 * (k % 3)
        ephs.append(Ephemeris(**d))
    return ephs


def sky(sig: Signal, traffic: dict, seed: int) -> Sky:
    """bench_constellation's sky: the n_sats highest of the 24 orbits at
    the drawn start time, LNAV subframes from that time, 2 s of filler
    bits before the first subframe, plus the first absent PRNs."""
    rng = np.random.default_rng([int(seed), 1])
    sky_p = traffic["sky"]
    tow0_6s = GPS_TOW0_6S + int(rng.integers(-sky_p["start_span_6s"],
                                             sky_p["start_span_6s"] + 1))
    clock_bias = float(rng.uniform(0.0, sky_p["clock_bias_max_s"]))
    duration_s = traffic["recording_ms"] * 1e-3 + 1.0
    recv = GPS_RECV_ECEF.copy()
    ephs = gps_orbits()
    pos, _ = satpos(tow0_6s * 6.0, ephs)
    _, el, _ = topocent(recv, pos - recv)
    order = np.argsort(-el)[: sky_p["n_sats"]]
    chosen = {int(k) + 1: ephs[k] for k in order}
    lead_s = 2.0
    bit_s = sig.bit_len_codes * sig.code_length / sig.code_freq
    n_lead = int(round(lead_s / bit_s))
    n_sf = int(np.ceil((duration_s + 8.0) / 6.0))
    tow0 = tow0_6s * 6.0
    sats = []
    for prn, eph in sorted(chosen.items()):
        _, clk = satpos(tow0, [eph])
        tau0, taud, taudd = fit_delay(eph, recv, tow0 - lead_s, duration_s)
        filler = rng.choice([-1.0, 1.0], size=n_lead)
        filler[-2:] = 1.0
        sats.append(Sat(
            prn=prn, doppler_hz=-GPS_CARRIER_HZ * taud,
            doppler_rate=-GPS_CARRIER_HZ * taudd,
            code_phase_chips=(tau0 - float(clk[0]) + clock_bias)
            * sig.code_freq,
            carrier_phase=float(rng.uniform(0, 2 * np.pi)),
            cn0_dbhz=float(sky_p["cn0_dbhz"]),
            nav_bits=np.concatenate([
                filler, lnav.encode_frames(eph, tow0=tow0_6s,
                                           n_subframes=n_sf)])))
    prns = sorted(chosen)
    absent = [p for p in range(1, 33) if p not in prns][: sky_p["n_absent"]]
    on_air = lead_s + 3 * 6.0 + max(s.code_phase_chips for s in sats) \
        / sig.code_freq
    return Sky(signal=sig, sats=sats, prns=prns, absent=absent,
               recv_ecef=recv, ephs=chosen, ephemeris_on_air_s=on_air)
