"""manager.dispatch_pct: the host's dispatch of each superepoch's launches and
its wait for their results (task_health 'track' + 'readback',
runtime/manager.py), summed over the traced window, as a share of the
window's wall time."""

from __future__ import annotations


def read(ctx: dict):
    """Percent of the traced window, or None when the window has none
    of these stages."""
    s = ctx["stage_s"]
    if not any(k in s for k in ("track", "readback")):
        return None
    return 100.0 * (s.get("track", 0.0) + s.get("readback", 0.0)) / ctx["window_s"]
