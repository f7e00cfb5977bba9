"""k2.roofline_pct: kernel K2's share of its roofline in the live receiver:
the least time the card could take for one launch (peaks.launch_work of
kernels/K2.json, and peaks.bound_s) over K2's mean device time per
launch in the profiler's trace of the window."""

from __future__ import annotations

from portbench import peaks


def read(ctx: dict):
    """Percent, or None when the trace holds no K2 launch."""
    kern = ctx["kernels"].get("K2")
    got = None if kern is None else ctx["trace"].kernel(kern["symbol"])
    if got is None or got[0] == 0:
        return None
    n, seconds = got
    bound = peaks.bound_s(*peaks.launch_work(kern, ctx["config"]))
    return 100.0 * bound / (seconds / n)
