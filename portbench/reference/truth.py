"""What an ideal receiver outputs for a sky: the plain reference.

From the inputs the benchmark made (the sky's streams, ephemerides and
receiver position), in NumPy float64, it works out
for any receive instant each satellite's carrier Doppler, its code phase
and the symbol on the air, the ephemeris a decoder must read from the
LNAV words (the broadcast fields rounded to their scale factors), and the
receiver's position. It imports nothing of the program and takes nothing
the program made: the program's outputs are only read to say where to
evaluate (the receive instants they are time-tagged with).
"""

from __future__ import annotations

import dataclasses

import numpy as np

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


def broadcast_value(value: float, scale: float, bits: int, signed: bool,
                    semicircles: bool) -> float:
    """The value a field reads after the LNAV words carry it: rounded to
    its scale, wrapped to its bit width."""
    unit = scale * (np.pi if semicircles else 1.0)
    q = int(round(value / unit)) & ((1 << bits) - 1)
    if signed and q >= 1 << (bits - 1):
        q -= 1 << bits
    return q * unit


def broadcast_ephemeris(eph) -> dict:
    """{field: value} a decoder must read for one satellite."""
    out = {k: broadcast_value(getattr(eph, k), *v)
           for k, v in LNAV_FIELDS.items()}
    out.update({k: int(getattr(eph, k)) for k in LNAV_INTS})
    return out


@dataclasses.dataclass
class Stream:
    """One transmitted code stream's truth (a sky's Sat) with its
    signal's constants."""

    sat: object
    fs: float
    code_freq: float
    code_length: int
    carrier_hz: float
    bit_len_codes: int

    def _t(self, sample):
        return np.asarray(sample, np.float64) / self.fs

    def doppler_hz(self, sample) -> np.ndarray:
        """Carrier Doppler [Hz] at receive sample indexes."""
        return self.sat.doppler_hz + self.sat.doppler_rate * self._t(sample)

    def chips(self, sample) -> np.ndarray:
        """Chips of the code received by these sample indexes."""
        t = self._t(sample)
        scale = 1.0 + (self.sat.doppler_hz
                       + 0.5 * self.sat.doppler_rate * t) / self.carrier_hz
        return self.code_freq * t * scale - self.sat.code_phase_chips

    def code_error_chips(self, sample) -> np.ndarray:
        """Signed distance [chips] of each index from the nearest start of
        a code period."""
        L = self.code_length
        return np.mod(self.chips(sample) + L / 2, L) - L / 2

    def symbols(self, sample) -> np.ndarray:
        """+-1 symbol on the air in the code period that ends nearest each
        sample index (a prompt is time-tagged with its period's end)."""
        n = np.rint(self.chips(sample) / self.code_length).astype(np.int64) - 1
        bits = np.asarray(self.sat.nav_bits, np.float64)
        idx = np.clip(n // self.bit_len_codes, 0, len(bits) - 1)
        return bits[idx]

    def code_starts(self, first: float, n: int) -> np.ndarray:
        """Sample indexes of n consecutive code-period starts from the
        one nearest `first` (Newton on chips(sample) = k L), in float64."""
        L = self.code_length
        k0 = np.rint(self.chips(first) / L)
        k = k0 + np.arange(n)
        s = first + (k - k0) * L * self.fs / self.code_freq
        for _ in range(3):
            rate = self.code_freq / self.fs * (
                1.0 + (self.sat.doppler_hz
                       + self.sat.doppler_rate * s / self.fs)
                / self.carrier_hz)
            s = s - (self.chips(s) - k * L) / rate
        return s


def streams_of(sky) -> dict:
    """{code-stream prn: Stream} of a sky."""
    sig = sky.signal
    return {s.prn: Stream(s, sig.fs, sig.code_freq, sig.code_length,
                          sig.carrier_hz, sig.bit_len_codes)
            for s in sky.sats}
