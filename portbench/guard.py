"""The import guard: which refused top-level packages a process has
loaded. Names are compared whole (the part of a module's name before the
first dot), so gnsstpu_torch is not gnsstpu."""

from __future__ import annotations

import sys


def loaded(refused, modules=None) -> list:
    """Sorted names in `modules` (default sys.modules) whose top-level
    package is one of `refused`."""
    mods = sys.modules if modules is None else modules
    refused = set(refused)
    return sorted(m for m in mods if m.split(".", 1)[0] in refused)
