"""GLONASS L3OC data demodulation: overlay sync + symbol decode.

The L3OC data component carries 100 bps nav data through a rate-1/2 K=7
convolutional coder -> 200 sps symbols, each symbol spread over 5 code
periods by the Barker(5) overlay; the pilot carries the NH(10) overlay
(reference simulator glonass_l3_generator.sce:63-67,146-149; the reference
L3 receiver ships the same convol_decoder library it uses for Galileo).

Decode chain on the prompt streams from tracking.dual:
  1. resolve the overlay epoch by correlating the pilot prompt signs
     against all 10 cyclic shifts of NH(10) (the same mechanism as the
     GLONASS L1 time-mark search, findTimeMarks.sci, at the 1 ms scale);
  2. wipe the Barker(5) overlay off the data prompt and integrate each
     group of 5 code periods into one 200 sps soft symbol;
  3. soft Viterbi-decode the symbol stream back to 100 bps bits
     (nav.viterbi, polys (133, 171) without inversion — the convention of
     the reference's decoder library, convol_decoder.sci:43-220).

The 2-quadrant Costas PLL leaves a possible common 180-degree phase flip;
both overlay sync and the decode are run for both polarities and the
better overlay correlation wins.

Copied from gnsstpu/nav/glonass_l3.py; only the import prefix differs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gnsstpu_torch.nav.viterbi import viterbi_decode
from gnsstpu_torch.signals.glonass_l3 import BARKER5, NH10

# The reference decoder library's polynomial convention (no inversion).
L3_POLYS = (0o133, 0o171)
L3_INVERT = (False, False)


@dataclasses.dataclass
class L3OverlaySync:
    found: bool
    # ms index (into the prompt stream) of the first code period that is
    # aligned with NH chip 0 (= a Barker epoch and a symbol boundary).
    first_ms: int = 0
    polarity: int = 1          # +1 or -1 common carrier-phase flip
    quality: float = 0.0       # mean |NH correlation| per 10 ms group


def sync_overlay(pilot_ip: np.ndarray) -> L3OverlaySync:
    """Find the NH(10) epoch in the pilot prompt stream (1 value / ms)."""
    n = len(pilot_ip) // 10 * 10
    if n < 20:
        return L3OverlaySync(False)
    x = np.sign(pilot_ip[:n]).reshape(-1, 10)            # [G, 10]
    best = (0.0, 0, 1)
    for shift in range(10):
        ref = np.roll(NH10.astype(np.float32), shift)
        c = float(np.mean(x @ ref)) / 10.0
        if abs(c) > abs(best[0]):
            best = (c, shift, 1 if c > 0 else -1)
    c, shift, pol = best
    if abs(c) < 0.75:
        return L3OverlaySync(False)
    # x[i] = pol * NH[(i + off) % 10] matches ref = roll(NH, shift) at
    # shift = -off mod 10; the next epoch (overlay index 0) is at
    # i = shift.
    return L3OverlaySync(True, first_ms=shift, polarity=pol,
                         quality=abs(c))


def symbols_from(data_ip: np.ndarray, sync: L3OverlaySync) -> np.ndarray:
    """Barker-wiped 200 sps soft symbols from the data prompt stream.

    NH(10) and Barker(5) epochs coincide every 10 ms; symbols are 5 ms.
    """
    x = np.asarray(data_ip, np.float64)[sync.first_ms:] * sync.polarity
    n = len(x) // 5 * 5
    g = x[:n].reshape(-1, 5)
    return g @ BARKER5.astype(np.float64)


def decode_data(data_ip: np.ndarray, sync: L3OverlaySync,
                n_bits: Optional[int] = None) -> np.ndarray:
    """Viterbi-decode the data prompt stream to 100 bps bits (0/1).

    The symbol stream is treated as one flushed codeword (the test
    fixture encodes with tail bits; live frames would be segmented by the
    frame preamble first).
    """
    sym = symbols_from(data_ip, sync)
    if n_bits is not None:
        sym = sym[: 2 * (n_bits + 6)]
    return viterbi_decode(sym, polys=L3_POLYS, invert=L3_INVERT)
