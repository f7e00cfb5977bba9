"""gnsstpu_torch — the gnsstpu GNSS receiver on PyTorch and CUDA.

A second package beside `gnsstpu` (the JAX reference). It mirrors the
reference's module layout so each counterpart is easy to find
(`gnsstpu_torch/ops/track_kernel.py` <-> `gnsstpu/ops/track_kernel.py`),
keeps the reference's array layouts at its public functions, and imports
`torch` and never `jax`, nor anything of `gnsstpu`: host code that has
no JAX in it (config, signal definitions, code tables, nav decode, PVT,
the online navigator, telemetry, the command console) is carried as the
port's own copy of the reference module, with only the import prefix
changed (tests/test_torch_copies.py guards against drift).

Plain tensor code is PyTorch; each TPU kernel on a ported path is a
hand-written CUDA kernel for Hopper with its plain PyTorch twin beside
the wrapper: `track_chunk_fused` (K1, `csrc/track_fused.cu`, the GPS L1
C/A path) and `track_chunk_boc_fused` (K2, `csrc/track_boc_fused.cu`, the
Galileo E1B path). Entry points run on the card (`device="cuda"`) unless
the caller asks for the CPU.
"""

__version__ = "0.1.0"

from gnsstpu_torch.config import (  # noqa: F401
    AcqConfig,
    NavConfig,
    ReceiverConfig,
    SignalConfig,
    TrackConfig,
)
