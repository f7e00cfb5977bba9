"""live.superepoch_ms_p95: the 95th percentile, over every superepoch
harvested in the traced window, of the host's wall time from the previous
harvest of its pass (or the pass's start) to its own."""

from __future__ import annotations


def read(ctx: dict):
    """Milliseconds, or None when nothing was harvested."""
    w = ctx["window"]
    if not w["superepochs"]:
        return None
    return w["superepoch_ms_p95"]
