"""Ranging and overlay codes of the benchmark's signals, and the L3OC data
coder: a frozen copy (NumPy) of what the port's signals/ and nav/viterbi.py
hold, so that the yardstick stays fixed when the program changes.

GPS L1 C/A: G1/G2 Gold codes per IS-GPS-200 table 3-I, chips +-1 with +1
for binary 1. GLONASS L3OC: chip i = -(g1_i * g2_i), g1 a 14-stage
m-sequence, g2 a 7-stage register seeded by binary(PRN); pilot codes are
PRN 1..31, data codes PRN + 32; NH(10) pilot and Barker(5) data overlays.
The data symbols come from a rate-1/2 K=7 convolutional coder.
"""

from __future__ import annotations

import functools

import numpy as np

CA_LENGTH = 1023
L3_CARRIER_HZ = 1202.025e6
L3_CODE_FREQ = 10.23e6
L3_LENGTH = 10230
NH10 = np.array([-1, -1, -1, -1, 1, 1, -1, 1, -1, 1], np.int8)
BARKER5 = np.array([-1, -1, -1, 1, -1], np.int8)
#: The L3OC data coder: generator polynomials (octal), no inversion.
L3_POLYS = (0o133, 0o171)
L3_INVERT = (False, False)

_G2_DELAY = np.array(
    [5, 6, 7, 8, 17, 18, 139, 140, 141, 251,
     252, 254, 255, 256, 257, 258, 469, 470, 471, 472,
     473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
     861, 862, 145, 175, 52, 21, 237], np.int64)
_L3_G1_INIT = np.array([1, 1, -1, -1, 1, -1, 1, 1, -1, -1, -1, 1, 1, 1],
                       np.int8)


@functools.lru_cache(maxsize=1)
def _ca_all() -> np.ndarray:
    g1 = np.empty(CA_LENGTH, np.int8)
    g2 = np.empty(CA_LENGTH, np.int8)
    r1 = -np.ones(10, np.int8)
    r2 = -np.ones(10, np.int8)
    for i in range(CA_LENGTH):
        g1[i] = r1[9]
        g2[i] = r2[9]
        fb1 = r1[2] * r1[9]
        fb2 = r2[1] * r2[2] * r2[5] * r2[7] * r2[8] * r2[9]
        r1[1:] = r1[:-1]
        r2[1:] = r2[:-1]
        r1[0] = fb1
        r2[0] = fb2
    idx = (np.arange(CA_LENGTH)[None, :]
           - (_G2_DELAY % CA_LENGTH)[:, None]) % CA_LENGTH
    return (-(g1[None, :] * g2[idx])).astype(np.int8)


def ca_code(prn: int) -> np.ndarray:
    """GPS C/A code of PRN 1..37, +-1 int8 [1023]."""
    if not 1 <= prn <= len(_G2_DELAY):
        raise ValueError(f"C/A PRN must be in 1..{len(_G2_DELAY)}: {prn}")
    return _ca_all()[prn - 1].copy()


@functools.lru_cache(maxsize=1)
def _l3_g1() -> np.ndarray:
    reg = _L3_G1_INIT.copy()
    out = np.empty(L3_LENGTH, np.int8)
    for i in range(L3_LENGTH):
        out[i] = reg[13]
        fb = reg[3] * reg[7] * reg[12] * reg[13]
        reg[1:] = reg[:-1]
        reg[0] = fb
    return out


@functools.lru_cache(maxsize=None)
def l3_code(prn: int) -> np.ndarray:
    """GLONASS L3OC code of PRN 1..63 (data codes are satellite + 32),
    +-1 int8 [10230]."""
    if not 1 <= prn <= 63:
        raise ValueError(f"L3OC PRN must be in 1..63: {prn}")
    reg = np.array([-1 if (prn >> (6 - k)) & 1 else 1 for k in range(7)],
                   np.int8)
    g2 = np.empty(L3_LENGTH, np.int8)
    for i in range(L3_LENGTH):
        g2[i] = reg[6]
        fb = reg[5] * reg[6]
        reg[1:] = reg[:-1]
        reg[0] = fb
    return (-(_l3_g1() * g2)).astype(np.int8)


def conv_encode(bits: np.ndarray, polys=L3_POLYS, invert=L3_INVERT,
                K: int = 7) -> np.ndarray:
    """Rate-1/len(polys) convolutional code of 0/1 bits with K - 1 zero
    tail bits: interleaved 0/1 symbols."""
    u = np.concatenate([np.asarray(bits, np.int8), np.zeros(K - 1, np.int8)])
    padded = np.concatenate([np.zeros(K - 1, np.int8), u])
    out = np.zeros((len(u), len(polys)), np.int8)
    for j, (p, inv) in enumerate(zip(polys, invert)):
        taps = [(p >> (K - 1 - i)) & 1 for i in range(K)]
        acc = np.zeros(len(u), np.int8)
        for i in range(K):
            if taps[i]:
                acc ^= padded[K - 1 - i:len(padded) - i]
        out[:, j] = acc ^ (1 if inv else 0)
    return out.reshape(-1)
