"""manager.assess_pct: the manager's host supervision of harvested superepochs
(the program's task_health 'assess' stage, runtime/manager.py) less the
navigator's 'pvt' inside it, summed over the traced window, as a share of
the window's wall time."""

from __future__ import annotations


def read(ctx: dict):
    """Percent of the traced window, or None when the window has none
    of these stages."""
    s = ctx["stage_s"]
    if not any(k in s for k in ("assess",)):
        return None
    return 100.0 * (s.get("assess", 0.0) - s.get("pvt", 0.0)) / ctx["window_s"]
