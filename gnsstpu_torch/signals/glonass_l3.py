"""GLONASS L3OC CDMA signal: ranging codes and overlay codes.

The new CDMA signal at 1202.025 MHz (reference GLONASS/L3 Scilab receiver,
GLONASS/L3/initSettings.sci: fs=24 MHz, IF=-2.025 MHz, 10230 chips
@ 10.23 Mcps) with a data + pilot quadrature pair (reference simulator
GNSS_SOFTWARE_SIMULATORS/SCILAB/GLONASS/L3/glonass_l3_generator.sce:63-149):

  * pilot component (I): code(prn) x NH(10) overlay @ 1 kchip/s,
  * data component (Q): code(prn + 32) x Barker(5) overlay x 200 sps
    symbols (100 bps data through a rate-1/2 K=7 convolutional coder).

Code generator (reference GLONASS/L3/include/generateCAcode.sci:108-143 and
the simulator's include/generateL3code.sci — same algorithm, registers
swapped in naming): chip i = -(g1_i * g2_i) in +-1 arithmetic, where
  * g1: 14-stage m-sequence, feedback = product of stages {4, 8, 13, 14},
    output stage 14, fixed init pattern;
  * g2: 7-stage register, feedback = product of stages {6, 7}, output
    stage 7, initialized from the 7-bit binary expansion of the PRN number
    (the reference's 63-row g2s table is exactly binary(PRN) mapped
    0 -> +1, 1 -> -1 after its leading -1* factor);
truncated at 10230 chips (1 ms @ 10.23 Mcps).

PRN convention: 1..31 are pilot codes; data codes are PRN + 32 (33..63).

Copied from gnsstpu/signals/glonass_l3.py; only the import prefix differs.
"""

from __future__ import annotations

import functools

import numpy as np

CARRIER_HZ = 1202.025e6
CODE_FREQ = 10.23e6
CODE_LENGTH = 10230
NUM_PRN = 63              # 1..31 pilot, 33..63 data (32 unused)

# Pilot overlay, 10 chips @ 1 kchip/s (generator .sce:66).
NH10 = np.array([-1, -1, -1, -1, 1, 1, -1, 1, -1, 1], np.int8)
# Data overlay, 5 chips @ 1 kchip/s (generator .sce:67).
BARKER5 = np.array([-1, -1, -1, 1, -1], np.int8)

# g1 init register, stage 1 first (generateCAcode.sci:112 after the -1*).
_G1_INIT = np.array([1, 1, -1, -1, 1, -1, 1, 1, -1, -1, -1, 1, 1, 1],
                    np.int8)


@functools.lru_cache(maxsize=1)
def _g1_sequence() -> np.ndarray:
    reg = _G1_INIT.copy()
    out = np.empty(CODE_LENGTH, np.int8)
    for i in range(CODE_LENGTH):
        out[i] = reg[13]
        fb = reg[3] * reg[7] * reg[12] * reg[13]
        reg[1:] = reg[:-1]
        reg[0] = fb
    return out


@functools.lru_cache(maxsize=None)
def generate_l3_code(prn: int) -> np.ndarray:
    """L3OC ranging code for PRN 1..63 as +-1 int8 [10230]."""
    if not 1 <= prn <= NUM_PRN:
        raise ValueError(f"L3OC prn must be 1..{NUM_PRN}, got {prn}")
    # binary(prn) 7 bits MSB-first; bit 1 -> -1, bit 0 -> +1.
    bits = [(prn >> (6 - k)) & 1 for k in range(7)]
    reg = np.array([-1 if b else 1 for b in bits], np.int8)
    g2 = np.empty(CODE_LENGTH, np.int8)
    for i in range(CODE_LENGTH):
        g2[i] = reg[6]
        fb = reg[5] * reg[6]
        reg[1:] = reg[:-1]
        reg[0] = fb
    return (-(_g1_sequence() * g2)).astype(np.int8)


def pilot_prn(prn: int) -> int:
    """Registry PRN of the pilot component for satellite `prn` (1..31)."""
    return prn


def data_prn(prn: int) -> int:
    """Registry PRN of the data component for satellite `prn` (1..31)."""
    return prn + 32
