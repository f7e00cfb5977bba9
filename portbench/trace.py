"""Reduce a torch.profiler trace of the window to device numbers: time in
which a device operation ran (the union of kernel, copy and set
intervals), each operation's summed time, and the idle gaps between them,
each labelled with what the host was doing at its middle.

The host's side comes from the harness's own annotations, made while the
profiler runs: `window` around the measured window, `pass_setup` around
each pass's construction, and a zero-length `stage:<name>` at each
task_health record the program emits, whose wall time (kept beside it by
the subscriber, in the same order) dates the stage back from the mark.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Stages whose task_health record is emitted as the stage ends (so the
#: stage ran over [mark - wall_s, mark]).
TIMED_STAGES = ("readback", "assess", "pvt", "acquire")


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    ops: dict                 # device op name -> (count, seconds)
    idle_gaps: list           # [(label, seconds)], longest first

    def kernel(self, symbol: str):
        """(launches, seconds) of the device ops whose name holds
        symbol, or None when there are none."""
        hits = [v for k, v in self.ops.items() if symbol in k]
        if not hits:
            return None
        return sum(h[0] for h in hits), sum(h[1] for h in hits)


#: Activity types of work on the device (kernels, copies, sets); the
#: device timeline also holds annotation ranges, which are not work.
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_MARKS = ("window", "pass_setup")


def _mine(name: str) -> bool:
    return name in HOST_MARKS or name.startswith("stage:")


def _is_work(e, name: str) -> bool:
    """A kernel, copy or set on the device. Builds of torch without the
    event's activity type: any device event that is not the device-side
    range of an annotation."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type()) in DEVICE_WORK
    if "cuda" not in str(e.device_type()).lower():
        return False
    flag = getattr(e, "is_user_annotation", None)
    return not _mine(name) and not (flag is not None and flag())


def _events(prof) -> tuple:
    """(device work [(name, start_ns, end_ns)], the harness's host
    annotations [(name, start_ns, end_ns)]) of a finished profile."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if _is_work(e, name):
            dev.append((name, t0, t1))
        elif _mine(name) and "cuda" not in str(e.device_type()).lower():
            host.append((name, t0, t1))
    return dev, host


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged [n, 2] intervals of sorted-by-start [n, 2] intervals."""
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.array(out, np.float64).reshape(-1, 2)


def busy_s(prof) -> float:
    """Seconds in which a device operation ran over the whole of a
    profile that was started at the window's start and stopped once its
    work had ended (the union of kernel, copy and set intervals)."""
    dev, _ = _events(prof)
    iv = _union(np.array(sorted((a, b) for _, a, b in dev),
                         np.float64).reshape(-1, 2))
    return float(np.sum(iv[:, 1] - iv[:, 0])) * 1e-9 if len(iv) else 0.0


def summarize(prof, stage_walls: list, n_gaps: int = 10) -> Summary:
    """The window's device numbers. stage_walls: wall_s of each
    task_health record in the order the program emitted them."""
    dev, host = _events(prof)
    win = [h for h in host if h[0] == "window"]
    if not win:
        raise RuntimeError("the trace holds no 'window' annotation")
    w0, w1 = win[0][1], win[0][2]
    ops = {}
    iv = []
    for name, a, b in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        c, s = ops.get(name, (0, 0.0))
        ops[name] = (c + 1, s + (b - a) * 1e-9)
        iv.append((a, b))
    iv = _union(np.array(sorted(iv), np.float64).reshape(-1, 2))
    busy = float(np.sum(iv[:, 1] - iv[:, 0])) * 1e-9 if len(iv) else 0.0
    edges = np.concatenate([[w0], iv.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = [(a, b) for a, b in edges if b > a]
    spans = [(n, a, b) for n, a, b in host if n == "pass_setup"]
    marks = sorted((h for h in host if h[0].startswith("stage:")),
                   key=lambda h: h[1])
    for (name, t, _), wall in zip(marks, stage_walls):
        stage = name.split(":", 1)[1]
        if stage in TIMED_STAGES:
            spans.append((stage, t - wall * 1e9, t))
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n_gaps]:
        mid = 0.5 * (a + b)
        inside = [(s1 - s0, n) for n, s0, s1 in spans if s0 <= mid <= s1]
        label = min(inside)[1] if inside else "dispatch_or_other"
        labelled.append((f"host.{label}", (b - a) * 1e-9))
    return Summary(busy_s=busy, window_s=(w1 - w0) * 1e-9, ops=ops,
                   idle_gaps=labelled)
