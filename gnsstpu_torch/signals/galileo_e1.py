"""Galileo E1 Open Service signal: E1B primary codes, BOC(1,1) subcarrier.

Reference: GALILEO/E1 Scilab receiver. The E1B/E1C primary codes are
*memory codes* (no generator polynomial exists): the reference ships them
as a hex text table loaded by GALILEO/E1/include/readE1Bcode.sci and
resampled by makeE1BCodesTable.sci — 4092 chips @ 1.023 Mcps, 4 ms
period. The BOC(1,1) subcarrier ("meandr" in the reference,
initSettings.sci keys meandrFreqBasis = 2.046 MHz / meandrLength = 8184)
flips sign every half chip.

The real ICD code tables ship with the framework
(signals/data/galileo_e1_codes.npz: E1B + E1C primary codes from the
Galileo OS SIS ICD Annex C, bit-packed) and are served by default, so
recorded E1 IF data decodes out of the box. `load_codes(path)` still
overrides them from a user-supplied hex table (one hex string per PRN,
the readE1Bcode.sci format).

Copied from gnsstpu/signals/galileo_e1.py; only the import prefix differs.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Optional

import numpy as np

_DATA = Path(__file__).parent / "data" / "galileo_e1_codes.npz"

CODE_FREQ = 1.023e6          # primary-code chip rate [Hz]
CODE_LENGTH = 4092           # chips per 4 ms period
SUB_FREQ = 2.046e6           # BOC(1,1) subcarrier ("meandr") rate [Hz]
SUB_LENGTH = 8184            # meandr half-chips per period
NUM_PRN = 50
CARRIER_HZ = 1575.42e6

# E1C secondary code CS25_1 (ICD table, 25 chips over 100 ms), as ±1
# with 0 -> +1, 1 -> -1. Hex 0x380AD90 (25 bits: 0011100000001010110110010).
_CS25_BITS = np.array([int(b) for b in f"{0x380AD90:025b}"], np.int8)
CS25 = (1 - 2 * _CS25_BITS).astype(np.int8)

_user_codes: Optional[np.ndarray] = None


def load_codes(path: str) -> None:
    """Load real E1B primary codes from a hex table file.

    Format (the reference's galileo-primary-code.txt layout): one line per
    PRN, each a 1023-hex-digit string; bit k of the string (MSB first) is
    chip k, 0 -> +1, 1 -> -1.
    """
    global _user_codes
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip().rstrip(",")
            if not line:
                continue
            h = line.split()[-1].strip('"')
            bits = np.array(
                [int(b) for b in bin(int(h, 16))[2:].zfill(4 * len(h))],
                np.int8)[-CODE_LENGTH:]
            rows.append((1 - 2 * bits).astype(np.int8))
    if not rows:
        raise ValueError(f"no codes found in {path}")
    _user_codes = np.stack(rows)
    primary_code.cache_clear()
    composite_code.cache_clear()


@functools.lru_cache(maxsize=None)
def _icd_codes(component: str) -> np.ndarray:
    """ICD memory codes from the bundled packed-bit table.

    Returns ±1 int8 [50, 4092]; component 'e1b' or 'e1c'."""
    packed = np.load(_DATA)[component]
    bits = np.unpackbits(packed, axis=1)[:, :CODE_LENGTH]
    return (1 - 2 * bits.astype(np.int8)).astype(np.int8)


@functools.lru_cache(maxsize=None)
def primary_code(prn: int) -> np.ndarray:
    """±1 int8 [4092] E1B primary code for PRN 1..50.

    The real ICD memory code (bundled table), unless load_codes()
    registered a user table.
    """
    if not 1 <= prn <= NUM_PRN:
        raise ValueError(f"E1 PRN must be 1..{NUM_PRN}, got {prn}")
    if _user_codes is not None:
        return _user_codes[prn - 1]
    return _icd_codes("e1b")[prn - 1]


@functools.lru_cache(maxsize=None)
def pilot_code(prn: int) -> np.ndarray:
    """±1 int8 [4092] E1C (pilot) primary code for PRN 1..50, from the
    bundled ICD table. The full pilot spreading applies CS25 (25-chip
    secondary code over 100 ms) on top."""
    if not 1 <= prn <= NUM_PRN:
        raise ValueError(f"E1 PRN must be 1..{NUM_PRN}, got {prn}")
    return _icd_codes("e1c")[prn - 1]


def subcarrier() -> np.ndarray:
    """±1 int8 [8184] BOC(1,1) meandr: +1 on even half-chips.

    Matches the reference's meandr = ones; meandr(2:2:$) = -1
    (tracking.sci:164)."""
    m = np.ones(SUB_LENGTH, np.int8)
    m[1::2] = -1
    return m


@functools.lru_cache(maxsize=None)
def composite_code(prn: int) -> np.ndarray:
    """±1 int8 [8184] BOC(1,1)-modulated E1B code at the half-chip rate.

    composite[k] = code[k // 2] * meandr[k]. This is the matched replica
    used by acquisition and the signal simulator; the double-estimator
    tracker (tracking.boc) keeps code and subcarrier separate.
    """
    return (np.repeat(primary_code(prn), 2) * subcarrier()).astype(np.int8)
