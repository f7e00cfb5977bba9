"""k3.roofline_pct: kernel K3's share of its roofline in the live receiver:
the least time the card could take for one launch (peaks.launch_work of
kernels/K3.json, and peaks.bound_s) over K3's mean device time per
launch in the profiler's trace of the window."""

from __future__ import annotations

from portbench import peaks


def read(ctx: dict):
    """Percent, or None when the trace holds no K3 launch."""
    kern = ctx["kernels"].get("K3")
    got = None if kern is None else ctx["trace"].kernel(kern["symbol"])
    if got is None or got[0] == 0:
        return None
    n, seconds = got
    bound = peaks.bound_s(*peaks.launch_work(kern, ctx["config"]))
    return 100.0 * bound / (seconds / n)
