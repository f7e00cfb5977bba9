"""The benchmark's skies, drawn from --seed: a frozen copy of the port's
sim/scenario.py bench_constellation (the live GPS receiver's geometry-true
sky with LNAV frames; its Doppler rate mended to the delay's second
derivative, see _fit_delay) and of the L3OC sky of the port's live L3 check
(pilot code x NH(10) and, in quadrature, data code x Barker(5) x
rate-1/2 coded bits).

The seed draws what a recording of the same deployment would vary: for
GPS the start time within +-30 min of the ephemerides' reference time,
the receiver clock's offset (a common code delay), the carrier phases and
the filler bits; for L3OC the Dopplers (a permutation of one grid), the
Doppler rates, the code phases and the data bits. It never changes how
many satellites are in the sky, how many are absent, their C/N0 or the
length of the recording.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from portbench.gen import codes, lnav
from portbench.gen.orbit import Ephemeris, satpos, signal_delay, topocent

GPS_CARRIER_HZ = 1575.42e6
#: The true receiver position of the GPS sky [ECEF m].
GPS_RECV_ECEF = np.array([3427947.0, 603774.0, 5326967.0])
#: Truncated TOW (6 s units) of the ephemerides' reference time t_oe.
GPS_TOW0_6S = 44400


@dataclasses.dataclass
class Sat:
    """Truth of one transmitted code stream (the port's SatParams)."""

    prn: int
    doppler_hz: float = 0.0
    doppler_rate: float = 0.0
    if_offset_hz: float = 0.0
    code_phase_chips: float = 0.0
    carrier_phase: float = 0.0
    cn0_dbhz: float = 45.0
    nav_bits: Optional[np.ndarray] = None


@dataclasses.dataclass
class Signal:
    """Front end and signal: what the IF simulator needs."""

    name: str
    fs: float
    if_freq: float
    code_freq: float
    code_length: int
    carrier_hz: float
    bit_len_codes: int

    @property
    def samples_per_code(self) -> int:
        return round(self.fs * self.code_length / self.code_freq)

    def code(self, prn: int) -> np.ndarray:
        return (codes.ca_code(prn) if self.name == "gps_l1ca"
                else codes.l3_code(prn))


@dataclasses.dataclass
class Sky:
    """A recording's truth: the streams, the satellites the receiver
    should find and those it should not, and what they carry."""

    signal: Signal
    sats: list                      # Sat per code stream
    prns: list                      # satellites in the sky
    absent: list                    # pool PRNs not in the sky
    recv_ecef: Optional[np.ndarray] = None
    ephs: dict = dataclasses.field(default_factory=dict)   # GPS
    #: GPS: receive time [s from the recording's start] by which every
    #: satellite's subframes 1-3 have been on the air in full.
    ephemeris_on_air_s: Optional[float] = None


def signal_of(cfg: dict) -> Signal:
    s = cfg["signal"]
    return Signal(name=s["signal"], fs=float(s["fs"]),
                  if_freq=float(s["if_freq"]),
                  code_freq=float(s["code_freq"]),
                  code_length=int(s["code_length"]),
                  carrier_hz=float(s["carrier_hz"]),
                  bit_len_codes=int(s["bit_len_codes"]))


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


def _fit_delay(eph, recv, t_r0: float, T: float) -> tuple:
    """(tau0, first, second derivative) of the quadratic through the
    geometric delay at t_r0, t_r0 + T/2 and t_r0 + T. The IF simulator
    integrates the Doppler rate as the second derivative (pi fd_rate t^2
    in the carrier), so it takes 4 (tau2 - 2 tau1 + tau0) / T^2, not
    half of it: half leaves the code delay up to ~50 m off the geometry
    at the end of a 45 s recording, and the fixes ~100 m off."""
    tau0 = signal_delay(eph, recv, t_r0)
    tau1 = signal_delay(eph, recv, t_r0 + T / 2)
    tau2 = signal_delay(eph, recv, t_r0 + T)
    return (tau0, (4 * tau1 - 3 * tau0 - tau2) / T,
            4 * (tau2 - 2 * tau1 + tau0) / (T * T))


def gps_sky(sig: Signal, traffic: dict, seed: int) -> Sky:
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
        tau0, taud, taudd = _fit_delay(eph, recv, tow0 - lead_s, duration_s)
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


def l3_streams(sig: Signal, prns, dopplers, rates, code_phases, bits: dict,
               n_ms: int, cn0_dbhz: float) -> list:
    """Per satellite a pilot stream code(prn) x NH(10) and a data stream
    code(prn + 32) x Barker(5) x its bits, rate-1/2 coded (the codeword
    repeats), in quadrature."""
    sats = []
    nh = np.resize(codes.NH10.astype(np.float32), n_ms)
    barker = np.resize(codes.BARKER5.astype(np.float32), n_ms)
    for prn, fd, rate, cp in zip(prns, dopplers, rates, code_phases):
        sym = 1.0 - 2.0 * codes.conv_encode(bits[prn])
        data = np.repeat(np.resize(sym, -(-n_ms // 5)), 5)[:n_ms] * barker
        common = dict(doppler_hz=float(fd), doppler_rate=float(rate),
                      code_phase_chips=float(cp), cn0_dbhz=cn0_dbhz)
        sats += [Sat(prn=prn, nav_bits=nh, carrier_phase=0.0, **common),
                 Sat(prn=prn + 32, nav_bits=data, carrier_phase=np.pi / 2,
                     **common)]
    return sats


def l3_sky(sig: Signal, traffic: dict, seed: int) -> Sky:
    """The live L3OC check's sky: fixed satellites and absent PRNs,
    Dopplers a seeded permutation of an even grid over +-max, rates and
    code phases drawn, n_bits random data bits per satellite."""
    rng = np.random.default_rng([int(seed), 2])
    p = traffic["sky"]
    prns = list(p["prns"])
    n = len(prns)
    dopp = rng.permutation(np.linspace(-p["doppler_max_hz"],
                                       p["doppler_max_hz"], n))
    rates = rng.uniform(-p["rate_max_hz_s"], p["rate_max_hz_s"], n)
    cps = (np.arange(n) * sig.code_length / n
           + rng.uniform(0.0, 1000.0, n))
    bits = {prn: rng.integers(0, 2, p["n_bits"]).astype(np.int8)
            for prn in prns}
    n_ms = traffic["recording_ms"] + traffic["pad_ms"] + 20
    sats = l3_streams(sig, prns, dopp, rates, cps, bits, n_ms,
                      float(p["cn0_dbhz"]))
    return Sky(signal=sig, sats=sats, prns=prns, absent=list(p["absent"]))


SKIES = {"gps_l1ca": gps_sky, "glonass_l3oc": l3_sky}


def make_sky(cfg: dict, traffic: dict, seed: int) -> Sky:
    sig = signal_of(cfg)
    return SKIES[sig.name](sig, traffic, seed)
