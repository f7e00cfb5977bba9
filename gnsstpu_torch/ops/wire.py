"""Raw IF file-format decoders (host NumPy).

Copied from the NumPy fallbacks of gnsstpu/native/__init__.py
(decode_i8_iq, decode_i16_iq, decode_gn3s_2bit, decode_packed_4bit):
the port binds no native library, so these are its only decoders. They
give the same samples as the reference's native codecs (the reference's
tests pin the two bit-identical).
"""

from __future__ import annotations

import numpy as np

_LUT2 = np.array([-3.0, -1.0, 1.0, 3.0], np.float32)


def decode_i8_iq(raw: np.ndarray) -> np.ndarray:
    raw = np.ascontiguousarray(raw, np.int8)
    n = raw.size // 2
    out = np.empty((n, 2), np.float32)
    out[:, 0] = raw[: 2 * n: 2]
    out[:, 1] = raw[1: 2 * n: 2]
    return out


def decode_i16_iq(raw: np.ndarray) -> np.ndarray:
    raw = np.ascontiguousarray(raw, np.int16)
    n = raw.size // 2
    out = np.empty((n, 2), np.float32)
    out[:, 0] = raw[: 2 * n: 2]
    out[:, 1] = raw[1: 2 * n: 2]
    return out


def decode_gn3s_2bit(raw: np.ndarray) -> np.ndarray:
    """One complex sample per byte: I = bits 1:0, Q = bits 3:2, LUT
    {-3,-1,+1,+3} (gps_source.cpp:692)."""
    raw = np.ascontiguousarray(raw, np.uint8)
    n = raw.size
    out = np.empty((n, 2), np.float32)
    out[:, 0] = _LUT2[raw & 3]
    out[:, 1] = _LUT2[(raw >> 2) & 3]
    return out


def decode_packed_4bit(raw: np.ndarray) -> np.ndarray:
    """CPLD packing (data_packer.vhd): LE 16-bit words of 4 x 4-bit
    sign/mag real samples; sample k in bits [4k+3:4k]."""
    raw = np.ascontiguousarray(raw, np.uint16)
    n = raw.size * 4
    out = np.empty((n, 2), np.float32)
    nib = np.empty(n, np.uint16)
    for k in range(4):
        nib[k::4] = (raw >> (4 * k)) & 0xF
    mag = 2.0 * (nib & 7) + 1.0
    out[:, 0] = np.where(nib & 8, -mag, mag).astype(np.float32)
    out[:, 1] = 0.0
    return out
