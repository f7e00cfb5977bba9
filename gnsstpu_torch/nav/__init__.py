"""Copied from gnsstpu/nav/__init__.py; only the import prefix differs."""
from gnsstpu_torch.nav.types import Ephemeris  # noqa: F401
from gnsstpu_torch.nav import frame, lnav  # noqa: F401
