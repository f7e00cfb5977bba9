"""GLONASS L3OC pilot + data: the codes and the sky of the port's live L3
check (pilot code x NH(10) and, in quadrature, data code x Barker(5) x
rate-1/2 coded bits). No ephemeris is judged.

The seed draws the Dopplers (a permutation of one grid), the Doppler
rates, the code phases and the data bits.
"""

from __future__ import annotations

import numpy as np

from portbench.gen import codes
from portbench.gen.sky import Sat, Signal, Sky


def code(prn: int) -> np.ndarray:
    return codes.l3_code(prn)


def broadcast(eph) -> None:
    """The L3OC sky carries no ephemerides to judge."""
    return None


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


def sky(sig: Signal, traffic: dict, seed: int) -> Sky:
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
