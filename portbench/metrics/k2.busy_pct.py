"""k2.busy_pct: kernel K2's share of the card's busy time in the live
receiver: the device seconds of K2's launches (kernels/K2.json's symbol)
in the profiler's trace of the window, over the window's busy seconds
(the union of kernel, copy and set intervals, trace.summarize)."""

from __future__ import annotations


def read(ctx: dict):
    """Percent, or None when the trace holds no K2 launch."""
    kern = ctx["kernels"].get("K2")
    tr = ctx["trace"]
    got = None if kern is None else tr.kernel(kern["symbol"])
    if got is None or got[0] == 0 or tr.busy_s <= 0:
        return None
    return 100.0 * got[1] / tr.busy_s
