"""acquisition.fft_busy_pct: the acquisition searches' transforms
(ops/fft_acquire.py on cuFFT) as a share of the card's busy time: the
device seconds of every operation in the profiler's trace of the window
whose name holds 'fft' (cuFFT's kernels; no other kernel of the live
receiver is so named, and only the searches transform), over the
window's busy seconds (trace.summarize)."""

from __future__ import annotations


def read(ctx: dict):
    """Percent, or None when the trace holds no transform."""
    tr = ctx["trace"]
    hits = [s for name, (_, s) in tr.ops.items() if "fft" in name.lower()]
    if not hits or tr.busy_s <= 0:
        return None
    return 100.0 * sum(hits) / tr.busy_s
