"""Wire-format sample unpacking on the device (port of gnsstpu/ops/unpack.py).

Front ends ship 1-4 bit samples; the packed bytes cross the host->device
link and are unpacked on the device. Formats (bits per complex pair):
'iq8' 16, 'iq4' 8, 'sm2' 4 (GN3S sign/mag {-3,-1,+1,+3}), 'iq1' 2.

The format arithmetic and the host packer are copied from the reference
module (its NumPy packer; the port binds no native library); `unpack_np`
here is the jax-free host decode.
"""

from __future__ import annotations

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

    NumPy only: the reference's fallback for its native packer, which
    the reference's tests pin bit-identical to it.
    """
    n = np.asarray(iq).shape[0]
    if fmt in ("sm2", "iq1"):
        den = {"sm2": 2, "iq1": 4}[fmt]
        if n % den:
            raise ValueError(f"{fmt} needs a multiple-of-{den} count")
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


def unpack(packed: torch.Tensor, fmt: str) -> torch.Tensor:
    """uint8 wire bytes -> f32 [N, 2] on packed's device."""
    p = packed.to(torch.int32)
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


def unpack_np(packed: np.ndarray, fmt: str) -> np.ndarray:
    """Host-side unpack (fine-Doppler windows, host reads): f32 [N, 2]."""
    t = torch.from_numpy(np.ascontiguousarray(packed, np.uint8))
    return unpack(t, fmt).numpy()
