"""What an ideal receiver outputs for a sky: the plain reference.

From the inputs the benchmark made (the sky's streams, ephemerides and
receiver position), in NumPy float64, it works out
for any receive instant each satellite's carrier Doppler, its code phase
and the symbol on the air, the ephemeris a decoder must read from the
navigation words (the broadcast fields rounded to their scale factors, by
the field table of the signal's module), and the receiver's position. It
imports nothing of the program and takes nothing the program made: the
program's outputs are only read to say where to evaluate (the receive
instants they are time-tagged with).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def broadcast_value(value: float, scale: float, bits: int, signed: bool,
                    semicircles: bool, pi: float = np.pi) -> float:
    """The value a field reads after the navigation words carry it:
    rounded to its scale (times pi, the signal's own, for a field in
    semicircles), wrapped to its bit width."""
    unit = scale * (pi if semicircles else 1.0)
    q = int(round(value / unit)) & ((1 << bits) - 1)
    if signed and q >= 1 << (bits - 1):
        q -= 1 << bits
    return q * unit


def broadcast_fields(eph, fields: dict, ints, pi: float = np.pi) -> dict:
    """{field: value} a decoder must read of one satellite's ephemeris:
    each of `fields` ({name: (scale, bits, signed, semicircles)}, a
    signal's table) as its words carry it, each of `ints` as it is."""
    out = {k: broadcast_value(getattr(eph, k), *v, pi=pi)
           for k, v in fields.items()}
    out.update({k: int(getattr(eph, k)) for k in ints})
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
