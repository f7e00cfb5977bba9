"""acquisition.search_pct: the host-path acquisition searches (task_health
'acquire', acquisition/search.py + ops/fft_acquire.py), summed over the
traced window, as a share of the window's wall time."""

from __future__ import annotations


def read(ctx: dict):
    """Percent of the traced window, or None when the window has none
    of these stages."""
    s = ctx["stage_s"]
    if not any(k in s for k in ("acquire",)):
        return None
    return 100.0 * (s.get("acquire", 0.0)) / ctx["window_s"]
