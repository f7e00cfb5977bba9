"""Signal definitions: ranging-code generators and constellation metadata.

Each module exposes pure NumPy code generators returning ±1 int8 chip arrays.
Codes are generated once on the host and cached; device kernels consume
resampled code tables (see gnsstpu.ops.code_tables).

Copied from gnsstpu/signals/__init__.py; only the import prefix differs.
"""

from gnsstpu_torch.signals.registry import get_signal, SignalDef  # noqa: F401
