"""BeiDou (COMPASS) B1I ranging code and NH secondary code.

Reference: COMPASS/B1 Scilab receiver. Code generator per
COMPASS/B1/include/generateCAcode.sci:41-145 — two 11-stage LFSRs over
{-1,+1} seeded with the alternating pattern, G1 taps (1,7,8,9,10,11) out
of stage 11, G2 taps (1,2,3,4,5,8,9,11) with per-PRN output phase pairs;
2046 chips @ 2.046 Mcps. The NH(20) secondary code
(COMPASS/B1/include/decode_bd_data.sci:7) overlays one chip per code
period on D1 signals.

Copied from gnsstpu/signals/beidou_b1.py; only the import prefix differs.
"""

from __future__ import annotations

import functools

import numpy as np

CODE_FREQ = 2.046e6
CODE_LENGTH = 2046
NUM_PRN = 37
CARRIER_HZ = 1561.098e6

# Per-PRN G2 output tap pairs (1-based stages), generateCAcode.sci:58-137.
G2_PHASE = [
    (1, 3), (1, 4), (1, 5), (1, 6), (1, 8), (1, 9), (1, 10), (1, 11),
    (2, 7), (3, 4), (3, 5), (3, 6), (3, 8), (3, 9), (3, 10), (3, 11),
    (4, 5), (4, 6), (4, 8), (4, 9), (4, 10), (4, 11), (5, 6), (5, 8),
    (5, 9), (5, 10), (5, 11), (6, 8), (6, 9), (6, 10), (6, 11), (8, 9),
    (8, 10), (8, 11), (9, 10), (9, 11), (10, 11),
]

# NH(20) secondary code as ±1 (decode_bd_data.sci:7).
NH_CODE = np.array([-1, -1, -1, -1, -1, 1, -1, -1, 1, 1, -1, 1, -1, 1, -1,
                    -1, 1, 1, 1, -1], np.int8)


@functools.lru_cache(maxsize=None)
def generate_b1i_code(prn: int) -> np.ndarray:
    """±1 int8 [2046] B1I code for PRN 1..37."""
    if not 1 <= prn <= NUM_PRN:
        raise ValueError(f"B1I PRN must be 1..37, got {prn}")
    seed = -np.array([-1, 1, -1, 1, -1, 1, -1, 1, -1, 1, -1], np.int8)

    reg = seed.copy()
    g1 = np.empty(CODE_LENGTH, np.int8)
    for i in range(CODE_LENGTH):
        g1[i] = reg[10]
        fb = reg[0] * reg[6] * reg[7] * reg[8] * reg[9] * reg[10]
        reg[1:] = reg[:-1]
        reg[0] = fb

    reg = seed.copy()
    g2 = np.empty(CODE_LENGTH, np.int8)
    ta, tb = G2_PHASE[prn - 1]
    for i in range(CODE_LENGTH):
        g2[i] = reg[ta - 1] * reg[tb - 1]
        fb = (reg[0] * reg[1] * reg[2] * reg[3] * reg[4] * reg[7]
              * reg[8] * reg[10])
        reg[1:] = reg[:-1]
        reg[0] = fb

    return (g1 * g2).astype(np.int8)
