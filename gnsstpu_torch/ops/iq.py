"""I/Q sample-plane helpers.

The framework's wire format for sample streams is float32 [N, 2]
(I in column 0, Q in column 1) — "iq32". No complex dtype touches device
code (the TPU backend has no complex support, and split planes vectorize
better anyway); these converters exist for host-side interop and tests.

Copied from gnsstpu/ops/iq.py; only the import prefix differs.
"""

from __future__ import annotations

import numpy as np


def complex_to_iq(x: np.ndarray) -> np.ndarray:
    """complex -> f32 [N, 2]."""
    x = np.asarray(x)
    out = np.empty((*x.shape, 2), np.float32)
    out[..., 0] = x.real
    out[..., 1] = x.imag
    return out


def iq_to_complex(x: np.ndarray) -> np.ndarray:
    """f32 [..., 2] -> complex64 [...]."""
    x = np.asarray(x)
    return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
