"""navigator.pvt_pct: the online navigator's frame sync, decode and fixes
(task_health 'pvt', runtime/navigator.py), summed over the traced window,
as a share of the window's wall time."""

from __future__ import annotations


def read(ctx: dict):
    """Percent of the traced window, or None when the window has none
    of these stages."""
    s = ctx["stage_s"]
    if not any(k in s for k in ("pvt",)):
        return None
    return 100.0 * (s.get("pvt", 0.0)) / ctx["window_s"]
