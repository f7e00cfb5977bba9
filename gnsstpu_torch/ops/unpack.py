"""Wire-format sample unpacking on the device (port of gnsstpu/ops/unpack.py).

Front ends ship 1-4 bit samples; the packed bytes cross the host->device
link and are unpacked on the device. Formats (bits per complex pair):
'iq8' 16, 'iq4' 8, 'sm2' 4 (GN3S sign/mag {-3,-1,+1,+3}), 'iq1' 2.

The format arithmetic and the host packer are copied from the reference
module (the native packer of gnsstpu_torch.native, and its NumPy
fallback). The decode does not run that arithmetic per sample: every
format packs whole samples into a byte, so `unpack` gathers each byte's
row of a 256-row table the arithmetic built once (table); `unpack_np`,
the jax-free host decode, is the same gather on the CPU.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

#: bytes per complex sample pair, as (numerator, denominator)
WIRE_FORMATS = {"iq8": (2, 1), "iq4": (1, 1), "sm2": (1, 2),
                "iq1": (1, 4)}


def wire_bytes(fmt: str, n_samples: int) -> int:
    """Packed byte count for n_samples I/Q pairs."""
    num, den = WIRE_FORMATS[fmt]
    if n_samples % den:
        raise ValueError(f"{fmt}: sample count {n_samples} not a "
                         f"multiple of {den}")
    return n_samples * num // den


def samples_per_byte(fmt: str) -> float:
    num, den = WIRE_FORMATS[fmt]
    return den / num


def align(fmt: str) -> int:
    """Sample-index alignment required for a packed read."""
    return WIRE_FORMATS[fmt][1]


# --------------------------------------------------------------------------
# Host-side pack (producers, tests, simulators)
# --------------------------------------------------------------------------


def pack(iq: np.ndarray, fmt: str, scale: float = 1.0) -> np.ndarray:
    """Quantize float [N, 2] I/Q to the wire format; returns uint8 bytes.

    scale multiplies the input before quantization; for noise-dominated
    GNSS IF samples with std sigma, scale ~ 1/sigma puts the sm2
    mag threshold at ~1 sigma (near-optimal 2-bit quantizer).

    Uses the native multithreaded packer when the library is available
    (a live producer packs at the radio rate); NumPy otherwise —
    bit-identical outputs either way (tests pin this).
    """
    n = np.asarray(iq).shape[0]
    if fmt in ("sm2", "iq1"):
        den = {"sm2": 2, "iq1": 4}[fmt]
        if n % den:
            raise ValueError(f"{fmt} needs a multiple-of-{den} count")
    if fmt in WIRE_FORMATS:
        from gnsstpu_torch import native

        out = native.pack_wire(np.asarray(iq, np.float32), fmt,
                               float(scale))
        if out is not None:
            return out
    return pack_np(iq, fmt, scale)


def pack_np(iq: np.ndarray, fmt: str, scale: float = 1.0) -> np.ndarray:
    """pack's NumPy packer: its path without the native library, and
    the twin the native packer is held bit-identical to."""
    n = np.asarray(iq).shape[0]
    x = np.asarray(iq, np.float32) * np.float32(scale)
    if fmt == "iq8":
        return np.clip(np.round(x), -127, 127).astype(np.int8).reshape(
            -1).view(np.uint8)
    if fmt == "iq4":
        q = np.clip(np.round(x), -8, 7).astype(np.int8)
        lo = (q[:, 0] & 0x0F).astype(np.uint8)
        hi = ((q[:, 1] & 0x0F) << 4).astype(np.uint8)
        return lo | hi
    if fmt == "sm2":
        if n % 2:
            raise ValueError("sm2 needs an even sample count")
        sign = (x < 0).astype(np.uint8)                   # 1 = negative
        mag = (np.abs(x) >= 1.0).astype(np.uint8)          # |q| in {1, 3}
        nib = (sign[:, 0] | (mag[:, 0] << 1)
               | (sign[:, 1] << 2) | (mag[:, 1] << 3))     # [N]
        return (nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)
    if fmt == "iq1":
        if n % 4:
            raise ValueError("iq1 needs a multiple-of-4 sample count")
        bits = (x < 0).astype(np.uint8)                    # 1 = negative
        b = (bits[:, 0] | (bits[:, 1] << 1)).reshape(-1, 4)  # 2 bits/pair
        return (b[:, 0] | (b[:, 1] << 2) | (b[:, 2] << 4)
                | (b[:, 3] << 6)).astype(np.uint8)
    raise ValueError(f"unknown wire format {fmt!r}")


def _decode_arith(p: torch.Tensor, fmt: str) -> torch.Tensor:
    """The reference's decode arithmetic: int32 byte values -> f32
    [N, 2]. Run once per format over every byte value to build its
    table (table); no sample stream goes through it."""
    if fmt == "iq8":
        v = torch.where(p >= 128, p - 256, p).to(torch.float32)
        return v.reshape(-1, 2)
    if fmt == "iq4":
        i = p & 0x0F
        q = (p >> 4) & 0x0F
        i = torch.where(i >= 8, i - 16, i)
        q = torch.where(q >= 8, q - 16, q)
        return torch.stack([i, q], dim=1).to(torch.float32)
    if fmt == "sm2":
        nib = torch.stack([p & 0x0F, (p >> 4) & 0x0F], dim=1).reshape(-1)
        i = (1 + 2 * ((nib >> 1) & 1)) * (1 - 2 * (nib & 1))
        q = (1 + 2 * ((nib >> 3) & 1)) * (1 - 2 * ((nib >> 2) & 1))
        return torch.stack([i, q], dim=1).to(torch.float32)
    if fmt == "iq1":
        two = torch.stack([p & 3, (p >> 2) & 3, (p >> 4) & 3,
                           (p >> 6) & 3], dim=1).reshape(-1)
        i = 1 - 2 * (two & 1)
        q = 1 - 2 * ((two >> 1) & 1)
        return torch.stack([i, q], dim=1).to(torch.float32)
    raise ValueError(f"unknown wire format {fmt!r}")


#: Decode tables by (format, device), each built at its first use.
_TABLES: dict = {}
_TABLES_LOCK = threading.Lock()
#: unpack calls on a device other than the CPU since the last reset
#: (reset_decodes): each is one table decode of a chunk on the card.
DECODES = {"unpack": 0}
#: The element a table row is gathered as, by the row's bytes (iq8 4,
#: iq4 8, sm2 16; iq1's 32-byte row is two 16-byte elements).
_ELEMENTS = {4: torch.int32, 8: torch.int64, 16: torch.complex128}


def reset_decodes() -> None:
    DECODES["unpack"] = 0


def table(fmt: str, device) -> torch.Tensor:
    """f32 [256, 2 * samples_per_byte(fmt)] on device: row b holds byte
    b's decoded (I, Q) values in sample order (sm2 [256, 4], iq4
    [256, 2], iq1 [256, 8], iq8 [256, 1], half a pair). Every format
    packs whole samples into a byte, so the table is exact: it is
    _decode_arith run on the CPU over every byte value, uploaded once
    per (format, device) and cached."""
    key = (fmt, torch.device(device))
    lut = _TABLES.get(key)
    if lut is None:
        if fmt not in WIRE_FORMATS:
            raise ValueError(f"unknown wire format {fmt!r}")
        with _TABLES_LOCK:
            lut = _TABLES.get(key)
            if lut is None:
                every = torch.arange(256, dtype=torch.int32)
                lut = _decode_arith(every, fmt).reshape(256, -1).to(key[1])
                _TABLES[key] = lut
    return lut


def unpack(packed: torch.Tensor, fmt: str) -> torch.Tensor:
    """uint8 wire bytes -> f32 [N, 2] on packed's device: each byte's
    row of the format's table, gathered bit for bit.

    The gather is 1-D, over the table's rows viewed as single elements
    (sm2's 16-byte row one complex128): PyTorch's CUDA index_select,
    gather and indexing launch a 2-D row gather as one block a row,
    ~120x the byte bound at 12 MB of sm2, while a 1-D gather is
    elementwise. Two launches on the card for sm2, iq4 and iq8 (the
    int32 index cast and the gather; a uint8 index would be read as a
    mask, an int64 one doubles the index traffic), four for iq1, whose
    row is two elements."""
    lut = table(fmt, packed.device)
    if packed.device.type != "cpu":
        DECODES["unpack"] += 1
    row = 4 * lut.shape[1]
    elems = lut.view(_ELEMENTS[min(row, 16)]).reshape(-1)
    idx = packed.reshape(-1).to(torch.int32)
    if row > 16:
        k = row // 16
        idx = (idx * k).unsqueeze(1) + torch.arange(
            k, dtype=torch.int32, device=idx.device)
        idx = idx.reshape(-1)
    return elems.index_select(0, idx).view(torch.float32).reshape(-1, 2)


def unpack_np(packed: np.ndarray, fmt: str) -> np.ndarray:
    """Host-side unpack (fine-Doppler windows, host reads): f32 [N, 2]."""
    t = torch.from_numpy(np.ascontiguousarray(packed, np.uint8))
    return unpack(t, fmt).numpy()
