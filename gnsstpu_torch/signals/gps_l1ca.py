"""GPS L1 C/A (coarse/acquisition) Gold codes.

Behavioral reference: the G1/G2 LFSR generator of
`POSTPROCESSING_SCILAB_RECEIVERS/GPS/L1/include/generateCAcode.sci` and the
packed-integer variant in `osgnss_next_step/src/correlator/correlator.c:63-91`.
Implemented here as a vectorized NumPy LFSR over all 37 PRNs at once
(32 satellites + 5 reserved), per IS-GPS-200 table 3-I.

Chips are ±1 int8 with +1 encoding binary 1 (the SoftGNSS sign convention —
it makes demodulated nav bits come out upright; the BPSK sign itself is
arbitrary).

Copied from gnsstpu/signals/gps_l1ca.py; only the import prefix differs.
"""

from __future__ import annotations

import functools

import numpy as np

CODE_LENGTH = 1023
NUM_PRN = 32

# G2 output-tap delay (chips) per PRN, IS-GPS-200 table 3-I. Index 0 = PRN 1.
# Entries 33..37 are the reserved ground-transmitter codes.
G2_DELAY = np.array(
    [5, 6, 7, 8, 17, 18, 139, 140, 141, 251,
     252, 254, 255, 256, 257, 258, 469, 470, 471, 472,
     473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
     861, 862, 145, 175, 52, 21, 237],
    dtype=np.int64,
)


@functools.lru_cache(maxsize=None)
def _all_codes() -> np.ndarray:
    """Generate all 37 C/A codes, shape [37, 1023], chips in ±1 int8."""
    # G1: x^10 + x^3 + 1 ; G2: x^10 + x^9 + x^8 + x^6 + x^3 + x^2 + 1.
    # Registers hold ±1 (all-ones seed = -1 in this algebra); XOR = product.
    g1 = np.empty(CODE_LENGTH, dtype=np.int8)
    g2 = np.empty(CODE_LENGTH, dtype=np.int8)
    r1 = -np.ones(10, dtype=np.int8)
    r2 = -np.ones(10, dtype=np.int8)
    for i in range(CODE_LENGTH):
        g1[i] = r1[9]
        g2[i] = r2[9]
        fb1 = r1[2] * r1[9]
        fb2 = r2[1] * r2[2] * r2[5] * r2[7] * r2[8] * r2[9]
        r1[1:] = r1[:-1]
        r2[1:] = r2[:-1]
        r1[0] = fb1
        r2[0] = fb2
    # Delayed G2 per PRN via roll; code = -(g1 * g2_delayed).
    shifts = G2_DELAY % CODE_LENGTH
    idx = (np.arange(CODE_LENGTH)[None, :] - shifts[:, None]) % CODE_LENGTH
    g2d = g2[idx]
    return (-(g1[None, :] * g2d)).astype(np.int8)


def generate_ca_code(prn: int) -> np.ndarray:
    """C/A code for one PRN (1-based), shape [1023], ±1 int8."""
    if not 1 <= prn <= len(G2_DELAY):
        raise ValueError(f"PRN must be in 1..{len(G2_DELAY)}, got {prn}")
    return _all_codes()[prn - 1].copy()


def code_table() -> np.ndarray:
    """All 32 satellite C/A codes, shape [32, 1023], ±1 int8."""
    return _all_codes()[:NUM_PRN].copy()
