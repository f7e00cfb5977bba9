"""gnsstpu_torch — the gnsstpu GNSS receiver on PyTorch and CUDA.

A second package beside `gnsstpu` (the JAX reference). It mirrors the
reference's module layout so each counterpart is easy to find
(`gnsstpu_torch/ops/track_kernel.py` <-> `gnsstpu/ops/track_kernel.py`),
keeps the reference's array layouts at its public functions, and imports
`torch` and never `jax`. Host code that has no JAX in it (config, signal
definitions, code tables, nav decode, PVT, the online navigator,
telemetry) is reused from `gnsstpu` rather than copied.

Plain tensor code is PyTorch; the one TPU kernel on the live GPS path
(`track_chunk_fused`) is a hand-written CUDA kernel for Hopper
(`csrc/track_fused.cu`), with its plain PyTorch twin beside the wrapper.
Every function that touches a tensor takes an explicit `device`.
"""

__version__ = "0.1.0"

from gnsstpu.config import (  # noqa: F401
    AcqConfig,
    NavConfig,
    ReceiverConfig,
    SignalConfig,
    TrackConfig,
)
