"""Device selection and uint32 phase helpers.

The reference keeps carrier NCO phases in uint32 and lets the arithmetic
wrap mod 2^32 (gnsstpu/ops/nco.py). PyTorch's uint32 dtype supports too
few operations, so the port carries those values in int64 tensors masked
with `& 0xFFFFFFFF` after every add or multiply; the CUDA kernel uses
native `uint32_t`. Host arrays keep numpy uint32.
"""

from __future__ import annotations

import numpy as np
import torch

U32_MASK = 0xFFFFFFFF
_TWO32 = 1 << 32


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA request without a usable card
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() "
                "is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def f32(x: float) -> float:
    """A Python float holding exactly the float32 value of x, so a tensor
    op with it as the scalar matches the reference's f32 constant."""
    return float(np.float32(x))


def u32_tensor(x, device) -> torch.Tensor:
    """uint32 host values (numpy/int) -> int64 tensor on `device`."""
    return torch.as_tensor(np.asarray(x, np.uint32).astype(np.int64),
                           device=device)


def u32_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 u32-carrying tensor -> numpy uint32."""
    return (t.detach().cpu().numpy() & U32_MASK).astype(np.uint32)


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """Signed int32 view (as int64 values) of u32 values in [0, 2^32):
    the reference's pltpu.bitcast(u32 -> i32)."""
    return x - ((x >> 31) & 1) * _TWO32
