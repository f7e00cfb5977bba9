"""feed.upload_pct: the sample feed's uploads (runtime/sources.py +
ops/unpack.py) as the device timeline shows them: the seconds of every
host-to-card copy in the traced window (trace.summarize's ops whose name
holds 'HtoD'), as a share of the window. A feed that reads its recording
from host memory uploads each superepoch's sm2 bytes; one staged on the
card copies nothing but the manager's few bytes of per-superepoch
retargeting, so it reads about 0."""

from __future__ import annotations


def read(ctx: dict):
    """Percent of the traced window, or None when the device ran
    nothing."""
    tr = ctx["trace"]
    if tr.busy_s <= 0:
        return None
    up = sum(s for name, (_, s) in tr.ops.items() if "HtoD" in name)
    return 100.0 * up / tr.window_s
