"""GLONASS FDMA signals: ST ranging code and L1OF/L2OF definitions.

Reference: GLONASS/L1 Scilab receiver (the first open-source GLONASS SW
receiver, wiki/GLONASS_SCILAB_RECEIVER.wiki:5-7). ST code per
GLONASS/L1/include/generateSTcode.sci:1-10 — a 9-stage m-sequence, taps
(5, 9), output from stage 7, 511 chips @ 0.511 Mcps. All satellites share
the one code; they are separated in frequency (channels k = -7..6 spaced
562.5 kHz at L1, 437.5 kHz at L2 — GLONASS/L1/initSettings.sci keys
L1_IF_step / GLONASS_zero_channel).

Frequency-channel indexing convention: registry "prn" p in 1..14 maps to
FDMA channel k = p - 8.

Copied from gnsstpu/signals/glonass.py; only the import prefix differs.
"""

from __future__ import annotations

import functools

import numpy as np

L1_BASE_HZ = 1602.0e6
L1_STEP_HZ = 562.5e3
L2_BASE_HZ = 1246.0e6
L2_STEP_HZ = 437.5e3
CODE_FREQ = 0.511e6
CODE_LENGTH = 511
NUM_FREQ_CH = 14          # k = -7..6


def prn_to_freq_ch(prn: int) -> int:
    """Registry PRN index (1..14) -> FDMA frequency channel k (-7..6)."""
    return prn - 8


def freq_ch_to_prn(k: int) -> int:
    return k + 8


@functools.lru_cache(maxsize=1)
def generate_st_code() -> np.ndarray:
    """511-chip GLONASS ST code as ±1 int8.

    9-stage LFSR over {-1,+1} (multiplication = XOR), feedback from stages
    5 and 9, output from stage 7, all-(-1) seed; the emitted code is the
    negated register output (generateSTcode.sci:35-42).
    """
    reg = -np.ones(9, np.int8)
    out = np.empty(CODE_LENGTH, np.int8)
    for i in range(CODE_LENGTH):
        out[i] = reg[6]
        feedback = reg[4] * reg[8]
        reg[1:] = reg[:-1]
        reg[0] = feedback
    return (-out).astype(np.int8)


def st_code_for_prn(prn: int) -> np.ndarray:
    """All GLONASS satellites share the single ST code."""
    return generate_st_code()


P_CODE_FREQ = 5.11e6
P_CODE_LENGTH = 5_110_000      # truncated to 1 s


def generate_p_code(n_chips: int = P_CODE_LENGTH) -> np.ndarray:
    """GLONASS P ("VT") code as ±1 int8, first n_chips of the 1 s code.

    Spec per the reference L2 receiver's library
    (GLONASS/L2/include/generatePcode.sci:14-22): 25-stage LFSR over
    {-1,+1}, feedback = stage3 * stage25, output stage 25, all-(-1) seed,
    emitted chips negated, truncated at 5,110,000 chips (1 s @ 5.11 Mcps).

    TPU-first implementation detail: instead of the reference's 5.11M-step
    scalar loop, the m-sequence recurrence b[n] = b[n-3] ^ b[n-25]
    (characteristic polynomial 1 + x^3 + x^25) is repeatedly squared over
    GF(2) — p(x)^(2^k) = 1 + x^(3*2^k) + x^(25*2^k) also annihilates the
    sequence — so each numpy step extends the sequence by 3*2^k chips
    (geometric growth, ~100 vector ops for the full second).
    """
    if not 1 <= n_chips <= P_CODE_LENGTH:
        raise ValueError("n_chips must be in 1..5110000")
    # Bootstrap the first 25 output bits with the direct register model
    # (bit 1 == chip level -1 before the final negation).
    reg = np.ones(25, np.uint8)            # all -1 in ±1 form
    seed = np.empty(25, np.uint8)
    for i in range(25):
        seed[i] = reg[24]
        fb = reg[2] ^ reg[24]
        reg[1:] = reg[:-1]
        reg[0] = fb
    b = np.empty(n_chips, np.uint8)
    n = min(25, n_chips)
    b[:n] = seed[:n]
    L = n
    while L < n_chips:
        # Largest squared recurrence usable with L known terms.
        k = max(0, int(np.floor(np.log2(L / 25))))
        a3, a25 = 3 << k, 25 << k
        ext = min(a3, n_chips - L)
        b[L:L + ext] = b[L - a3:L - a3 + ext] ^ b[L - a25:L - a25 + ext]
        L += ext
    # chip = -(g1-style ±1 output): bit 1 (-1 level) -> +1 chip.
    return (2 * b.astype(np.int8) - 1).astype(np.int8)


def l1of_carrier(prn: int) -> float:
    return L1_BASE_HZ + prn_to_freq_ch(prn) * L1_STEP_HZ


def l2of_carrier(prn: int) -> float:
    return L2_BASE_HZ + prn_to_freq_ch(prn) * L2_STEP_HZ
