"""Wire-format sample unpacking on the device (port of gnsstpu/ops/unpack.py).

Front ends ship 1-4 bit samples; the packed bytes cross the host->device
link and are unpacked on the device. Formats (bits per complex pair):
'iq8' 16, 'iq4' 8, 'sm2' 4 (GN3S sign/mag {-3,-1,+1,+3}), 'iq1' 2.

The host packer and the format arithmetic are numpy and reused from the
reference module; `unpack_np` here is the jax-free host decode.
"""

from __future__ import annotations

import numpy as np
import torch

from gnsstpu.ops.unpack import (  # noqa: F401
    WIRE_FORMATS,
    align,
    pack,
    samples_per_byte,
    wire_bytes,
)


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
