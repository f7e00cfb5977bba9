"""device.idle_pct: the share of the traced window in which no operation
ran on the card, from the profiler's device timeline (trace.summarize)."""

from __future__ import annotations


def read(ctx: dict):
    """Percent, or None when the device ran nothing."""
    tr = ctx["trace"]
    if tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
