"""live.realtime_factor: seconds of signal the live receiver harvested in
the traced window over the wall time from the window's start to its last
harvest (cold-start passes back to back, each pass's construction
included), by the host's clock."""

from __future__ import annotations


def read(ctx: dict):
    """Signal seconds per wall second, or None when nothing was
    harvested."""
    w = ctx["window"]
    if not w["superepochs"]:
        return None
    return w["realtime_factor"]
