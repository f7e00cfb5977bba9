"""Bit synchronization and LNAV frame synchronization.

Reference semantics reproduced:
  - bit sync: histogram of prompt-I sign transitions mod 20 (the realtime
    receiver's Channel::BitLock, objects/channel.cpp:502-614); the Scilab
    receiver instead relies on preamble correlation directly.
  - frame sync: preamble correlation on 20-ms-upsampled ±1 preamble, 6000 ms
    spacing check, and two-word parity confirmation
    (GPS/L1/findPreambles.sci:49-167).

Host-side NumPy (scalar/branchy — see SURVEY.md L4 note), but the heavy
correlation is a single np.correlate over the whole run.

Copied from gnsstpu/nav/frame.py; only the import prefix differs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gnsstpu_torch.nav import lnav


def bit_sync(prompt_i: np.ndarray, bit_len: int = 20) -> int:
    """Find the bit-edge offset in [0, bit_len) from prompt-I sign flips.

    Histogram of transition positions mod bit_len (channel.cpp:502-614
    histogram method). Returns offset k such that bits start at indices
    k, k+bit_len, ...
    """
    s = np.sign(prompt_i)
    flips = np.nonzero(s[1:] != s[:-1])[0] + 1
    if len(flips) == 0:
        return 0
    hist = np.bincount(flips % bit_len, minlength=bit_len)
    return int(np.argmax(hist))


def extract_bits(prompt_i: np.ndarray, bit_offset: int,
                 bit_len: int = 20) -> np.ndarray:
    """Integrate prompt I over each bit period -> ±1 bit stream."""
    x = prompt_i[bit_offset:]
    n_bits = len(x) // bit_len
    sums = x[:n_bits * bit_len].reshape(n_bits, bit_len).sum(axis=1)
    return np.sign(sums + 1e-30)


@dataclasses.dataclass
class FrameSync:
    """Result of preamble search on one channel."""

    found: bool
    # Index (in ms) into the prompt stream of the first bit of the first
    # confirmed preamble (the firstSubFrame of findPreambles.sci).
    first_subframe_ms: Optional[int] = None
    bit_offset: int = 0
    # Polarity: +1 if prompt-I sign == bit value convention (0 -> +1).
    polarity: int = 1
    # D29*/D30* of the word preceding the first subframe (both seed the
    # first word's parity chain in the decoder).
    d30_star: int = 0
    d29_star: int = 0


def find_preamble(prompt_i: np.ndarray, bit_len: int = 20) -> FrameSync:
    """Locate the LNAV subframe start in a prompt-I stream (1 ms cadence).

    findPreambles.sci:49-167 restructured: bit sync first (histogram), then
    preamble correlation at the bit level, 300-bit spacing check, and parity
    confirmation of the two words spanning the candidate (which requires 62
    bits: 2 before the preamble + TLM + HOW).
    """
    off = bit_sync(prompt_i, bit_len)
    bits = extract_bits(prompt_i, off, bit_len)
    if len(bits) < 362:
        return FrameSync(found=False)
    pre = 1.0 - 2.0 * lnav.PREAMBLE.astype(np.float64)  # ±1, bit0 -> +1
    corr = np.correlate(bits, pre, mode="valid")        # [n_bits-7]
    cand = np.nonzero(np.abs(corr) >= 8)[0]
    for c in cand:
        if c < 2 or c + 60 > len(bits):
            continue
        pol = 1 if corr[c] > 0 else -1
        seg01 = ((1 - pol * bits[c - 2:c + 60]) / 2).astype(np.int8)
        unit1 = seg01[0:32]
        unit2 = seg01[30:62]
        if lnav.parity_ok(unit1) and lnav.parity_ok(unit2):
            # Optional spacing confirmation with another preamble 300 bits on.
            nxt = c + 300
            if nxt < len(corr) and abs(corr[nxt]) < 8:
                continue
            return FrameSync(
                found=True,
                first_subframe_ms=off + c * bit_len,
                bit_offset=off,
                polarity=pol,
                d30_star=int(seg01[1]),
                d29_star=int(seg01[0]),
            )
    return FrameSync(found=False)


def bits_from(prompt_i: np.ndarray, sync: FrameSync,
              bit_len: int = 20) -> np.ndarray:
    """0/1 bit stream starting exactly at the first subframe boundary."""
    x = prompt_i[sync.first_subframe_ms:]
    n_bits = len(x) // bit_len
    sums = x[:n_bits * bit_len].reshape(n_bits, bit_len).sum(axis=1)
    return ((1 - sync.polarity * np.sign(sums + 1e-30)) / 2).astype(np.int8)
