"""The program's own spans over a traced run of a cell, and what metric
readers would compute from them.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

From the checkout's root, on the card. It makes the cell's traced run
(run.run with --trace 1: the same set-up, window, profile and check) with
the program's tracing on in every pass (Telemetry(trace=True)), and
prints one JSON line: the traced run's result line (`result`), and from
the spans of the window's passes and the profile:

  metrics       the numbers below, by name
  idle_by_span  the window's idle seconds on the card, by the innermost
                gnss.* range the window's thread was in ('unattributed':
                none)
  span_s        each span's seconds summed over the window, beside
                `stage_s`, the task_health walls they give
  k1            K1's mean time per launch from the program's CUDA events
                and from the profiler's trace, and the launches of each
  span_cost_ns  one span site's host cost, tracing off and on (with and
                without a profiler running)

run.py, system.py and trace.py hand no spans to the metric readers yet;
these functions are what readers of ctx["spans"] (the window's passes'
span records) and ctx["idle_by_span"] would compute.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from portbench import plan, run, trace  # noqa: E402

#: Prefix of the program's profiler ranges (runtime/telemetry.py).
PREFIX = "gnss."
UNATTRIBUTED = "unattributed"


def _secs(spans: list, name: str) -> list:
    return [(s["t1_ns"] - s["t0_ns"]) * 1e-9 for s in spans
            if s["name"] == name]


def superepoch_latency_ms_p95(spans: list):
    """p95 of the superepoch spans' durations (dispatch to the end of its
    supervision), ms; None without superepoch spans."""
    d = _secs(spans, "superepoch")
    return 1e3 * float(np.percentile(d, 95)) if d else None


def span_pct(spans: list, name: str, window_s: float):
    """The spans named `name`, summed, as a percent of the window's wall;
    None without such spans."""
    d = _secs(spans, name)
    return 100.0 * sum(d) / window_s if d else None


def k1_event_ms_per_signal_s(spans: list, signal_s: float):
    """K1's device time from the program's CUDA events (the superepoch
    spans' k1_device_ns), ms per second of signal harvested; None where
    no superepoch carries it (tracing off, or no K1 on a card)."""
    ns = [s["counters"]["k1_device_ns"] for s in spans
          if s["name"] == "superepoch" and "k1_device_ns" in s["counters"]]
    if not ns or signal_s <= 0:
        return None
    return 1e-6 * sum(ns) / signal_s


def idle_unattributed_pct(idle: dict, window_s: float):
    """The card's idle time in none of the program's spans, percent of
    the window; None without an idle_by_span table."""
    if not idle:
        return None
    return 100.0 * idle.get(UNATTRIBUTED, 0.0) / window_s


def idle_by_span(device: list, ranges: list, w0: int, w1: int) -> dict:
    """Seconds of the window [w0, w1] (ns) in which no device work ran
    (device: [(name, start_ns, end_ns)]), by the innermost of `ranges`
    ([(name, start_ns, end_ns)], nested, of one thread) covering them,
    under its name less the gnss. prefix; UNATTRIBUTED where none does.
    Empty when no device work ran in the window."""
    busy = sorted((max(a, w0), min(b, w1)) for _, a, b in device
                  if min(b, w1) > max(a, w0))
    if not busy:
        return {}
    iv = trace._union(np.array(busy, np.float64))
    edges = np.concatenate([[w0], iv.reshape(-1), [w1]]).reshape(-1, 2)
    idle = [(a, b) for a, b in edges if b > a]
    # Elementary segments of the thread's time, each labelled with the
    # innermost range open over it (at one instant: ends first, then
    # starts; an enclosing range opens before and closes after).
    marks = sorted([(a, 1, a - b, i) for i, (_, a, b) in enumerate(ranges)]
                   + [(b, 0, b - a, i) for i, (_, a, b) in enumerate(ranges)])
    starts, labels = [w0], [UNATTRIBUTED]
    stack = []
    for t, opens, _, i in marks:
        t = max(t, w0)
        if opens:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        name = ranges[stack[-1]][0][len(PREFIX):] if stack else UNATTRIBUTED
        if t == starts[-1]:
            labels[-1] = name
        else:
            starts.append(t)
            labels.append(name)
    out = {}
    for a, b in idle:
        j = max(bisect.bisect_right(starts, a) - 1, 0)
        while j < len(starts) and starts[j] < b:
            end = starts[j + 1] if j + 1 < len(starts) else b
            lo, hi = max(a, starts[j]), min(b, end)
            if hi > lo:
                out[labels[j]] = out.get(labels[j], 0.0) + (hi - lo) * 1e-9
            j += 1
    return out


def profile_events(prof) -> dict:
    """From a finished profile: the device work [(name, start_ns,
    end_ns)], the window [w0, w1] of the harness's `window` annotation,
    and the gnss.* ranges on the thread that holds it."""
    events = list(prof.profiler.kineto_results.events())
    win = [e for e in events if e.name() == "window"
           and "cuda" not in str(e.device_type()).lower()]
    if not win:
        raise RuntimeError("the trace holds no 'window' annotation")
    tid = win[0].start_thread_id()
    w0 = win[0].start_ns()
    device, ranges = [], []
    for e in events:
        name = e.name()
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if trace._is_work(e, name):
            device.append((name, t0, t1))
        elif (name.startswith(PREFIX) and e.start_thread_id() == tid
              and "cuda" not in str(e.device_type()).lower()):
            ranges.append((name, t0, t1))
    return {"device": device, "ranges": ranges,
            "window": (w0, w0 + win[0].duration_ns())}


def traced_run(args, device: str = "cuda", base=plan.HERE,
               bench: dict | None = None) -> tuple:
    """run.run(args with trace 1), with every pass's Telemetry tracing.
    Returns (its result, the spans of the window's passes, the profile's
    events as profile_events gives them)."""
    from gnsstpu_torch.runtime.telemetry import Telemetry

    from portbench import system

    made, seen = [], {}

    def traced_telemetry(**kw):
        made.append(Telemetry(trace=True, **kw))
        return made[-1]

    def summarize(prof, stage_walls, n_gaps=10):
        seen.update(profile_events(prof))
        return summarize_0(prof, stage_walls, n_gaps)

    summarize_0, telemetry_0 = trace.summarize, system.Telemetry
    trace.summarize, system.Telemetry = summarize, traced_telemetry
    try:
        res, _ = run.run(argparse.Namespace(**dict(vars(args), trace=1)),
                         device, base=base, bench=bench)
    finally:
        trace.summarize, system.Telemetry = summarize_0, telemetry_0
    # The first pass is the untimed warm pass.
    spans = [s for tlm in made[1:] for s in tlm.spans]
    return res, spans, seen


def span_cost_ns(n: int = 20000) -> dict:
    """Host nanoseconds of one span site (`with tlm.span(...)`, an empty
    body): tracing off, on, and on under a running profiler."""
    from torch.profiler import ProfilerActivity, profile

    from gnsstpu_torch.runtime.telemetry import Telemetry

    def per_site(tlm) -> float:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with tlm.span("cost", se=0):
                pass
        return (time.perf_counter_ns() - t0) / n

    out = {"off": per_site(Telemetry()), "on": per_site(Telemetry(
        trace=True))}
    with profile(activities=[ProfilerActivity.CPU]):
        out["on_profiled"] = per_site(Telemetry(trace=True))
    return out


#: Span names whose sums give task_health walls: span -> stage.
STAGE_OF = {"dispatch": "track", "harvest.wait": "readback",
            "readback": "readback", "supervise": "assess", "nav.poll": "pvt",
            "feed.upload": "upload", "acq.host_search": "acquire"}


def report(res: dict, spans: list, seen: dict, kernel: dict) -> dict:
    """The probe's line (see the module's docstring)."""
    window_s = res["window"]["wall_s"]
    w0, w1 = seen["window"]
    idle = idle_by_span(seen["device"], seen["ranges"], w0, w1)
    sym = [(b - a) for n, a, b in seen["device"] if kernel["symbol"] in n
           and a >= w0 and b <= w1]
    sup = [s["counters"] for s in spans if s["name"] == "superepoch"]
    k1_n = sum(c.get("k1_launches", 0) for c in sup)
    k1_ns = sum(c.get("k1_device_ns", 0) for c in sup)
    span_s = {}
    for s in spans:
        span_s[s["name"]] = span_s.get(s["name"], 0.0) + (
            s["t1_ns"] - s["t0_ns"]) * 1e-9
    return {
        "result": res,
        "metrics": {
            "live.superepoch_latency_ms_p95":
                superepoch_latency_ms_p95(spans),
            "navigator.decode_pct": span_pct(spans, "nav.decode", window_s),
            "navigator.solve_pct": span_pct(spans, "nav.solve", window_s),
            "k1.event_ms_per_signal_s": k1_event_ms_per_signal_s(
                spans, res["window"]["signal_s"]),
            "device.idle_unattributed_pct": idle_unattributed_pct(
                idle, (w1 - w0) * 1e-9)},
        "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "span_s": span_s, "stage_s": res["window"]["stage_s"],
        "stage_of": STAGE_OF,
        "k1": {"event_ms_per_launch": 1e-6 * k1_ns / k1_n if k1_n else None,
               "event_launches": k1_n,
               "profile_ms_per_launch": 1e-6 * sum(sym) / len(sym)
               if sym else None,
               "profile_launches": len(sym)},
        "n_spans": len(spans)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", "portbench_cache", sub)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    bench = plan.load_bench()
    cell = plan.plan(bench, args.workload)
    res, spans, seen = traced_run(args, "cuda", bench=bench)
    out = report(res, spans, seen, cell.kernel)
    out["span_cost_ns"] = span_cost_ns()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
