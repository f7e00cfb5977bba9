"""Run one cell of the benchmark of gnsstpu_torch once, on the card this
process is started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the checkout's root. Set-up (timed as setup_s, from the process's
start): load the tracking kernels (compiled into build/kernels/ by the
first run of a checkout), make the cell's recording on the card from the
seed and pack it to sm2 there, hand it to the feed (host memory, or staged
on the card), and run one untimed warm pass. Then the window: cold-start
passes of the live receiver (a fresh ChannelManager and OnlineNavigator
each) back to back for --seconds; the pass in flight at the deadline stops
at its next superepoch and its signal counts. After the window the
program's outputs of every completed pass are judged against the plain
reference (reference/compare.py), and the result is the last line of
standard output; the numbers compared, each beside its limit, are the last
lines of standard error.

With --trace 1 the window runs under torch.profiler and the result holds
the cell's per-layer metrics (metrics/<name>.py), the device's busy and
window seconds and a breakdown; with --trace 0, its end-to-end metrics,
the window then profiled for the device's activity alone (the device time
that device_ms_per_signal_s divides by the signal harvested).
Exits non-zero, printing no result, without a card, with fewer cards than
the cell asks for, without the program, or when jax, jaxlib, flax or the
JAX package were loaded.
"""

from __future__ import annotations

import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age_s()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402

from portbench import guard, plan  # noqa: E402

REFUSED = ("jax", "jaxlib", "flax", "gnsstpu")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))


def window_numbers(watch, t0: float) -> dict:
    """Realtime factor and superepoch p95 from the subscriber's stamps:
    each superepoch timed from the previous harvest of its pass, or from
    its pass's start."""
    if not watch.superepochs:
        return {"realtime_factor": 0.0, "superepoch_ms_p95": 0.0,
                "superepochs": 0, "signal_s": 0.0,
                "wall_s": time.perf_counter() - t0}
    gaps = []
    prev = {}
    for t, _, idx in watch.superepochs:
        gaps.append(t - prev.get(idx, watch.pass_start[idx]))
        prev[idx] = t
    t_last = watch.superepochs[-1][0]
    signal_s = sum(ms for _, ms, _ in watch.superepochs) * 1e-3
    return {"realtime_factor": signal_s / (t_last - t0),
            "superepoch_ms_p95": 1e3 * p95(gaps),
            "superepochs": len(gaps), "signal_s": signal_s,
            "wall_s": t_last - t0}


def stage_seconds(watch) -> dict:
    out = {}
    for _, stage, wall in watch.stages:
        out[stage] = out.get(stage, 0.0) + wall
    return out


def run(args, device: str = "cuda", base=plan.HERE,
        bench: dict | None = None) -> tuple:
    """Set-up, window and check of one run. Returns (result dict, rows of
    (number, value, limit)); raises on a fault of the harness."""
    import torch

    from portbench import system
    from portbench.gen import ifsim, sky as skymod
    from portbench.reference import compare

    bench = bench if bench is not None else plan.load_bench()
    cell = plan.plan(bench, args.workload, base)
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    if dev.type == "cuda":
        system.build_kernels()
    sky = skymod.make_sky(cfg, traffic, args.seed, base)
    n_rec = traffic["recording_ms"] + traffic["pad_ms"]
    packed_dev = ifsim.recording(sky, n_rec, args.seed, dev)
    levels = ifsim.sm2_levels(packed_dev).cpu().numpy()
    source = system.packed_source(levels, packed_dev.cpu().numpy(),
                                  traffic["feed"], dev)
    del packed_dev, levels
    rx = system.Receiver(cfg, source, sky.prns + sky.absent, dev)
    run_ms = traffic["recording_ms"]
    rx.run_pass(-1, run_ms)                       # warm pass, untimed
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    k_launch0 = system.launches(cell.kernel["counter"])

    watch = rx.watch
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = None
    prof_start_s = 0.0
    if args.trace:
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()

        def mark(stage, wall):
            with record_function(f"stage:{stage}"):
                pass
        watch.on_stage = mark
        win = record_function("window")
        win.__enter__()
    elif dev.type == "cuda":
        # The window's device time alone (device_ms_per_signal_s): no host
        # activity is recorded, so the host's pace is least disturbed.
        prof = profile(activities=[ProfilerActivity.CUDA])
        t_prof = time.perf_counter()
        prof.start()
        prof_start_s = time.perf_counter() - t_prof
    setup_s = time.perf_counter() - T_START
    watch.enabled = True
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    passes = []
    if args.trace:
        rx.span = record_function
    errors = []
    while time.perf_counter() < deadline:
        try:
            passes.append(rx.run_pass(len(passes), run_ms, deadline))
        except Exception as err:     # a program fault ends the window
            errors.append(f"pass {len(passes)}: {err!r}")
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    watch.enabled = False
    cpu_s = time.process_time() - cpu0
    if args.trace:
        win.__exit__(None, None, None)
    if prof is not None:
        prof.stop()
    nums = window_numbers(watch, t0)
    launches = system.launches(cell.kernel["counter"]) - k_launch0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    res = {"device": device_info(dev, peak)}
    from portbench import trace

    metrics = {}
    if args.trace:
        summ = trace.summarize(prof, [w for _, _, w in watch.stages])
        busy = summ.busy_s
    elif prof is not None:
        busy = trace.busy_s(prof)
    if prof is not None and nums["signal_s"] > 0:
        nums["device_ms_per_signal_s"] = 1e3 * busy / nums["signal_s"]
    if args.trace:
        ctx = {"config": cfg, "traffic": traffic, "window": nums,
               "window_s": nums["wall_s"], "stage_s": stage_seconds(watch),
               "trace": summ,
               "kernels": {cell.kernel["name"]: cell.kernel}}
        for m in cell.per_layer:
            v = plan.reader(m["name"], base / "metrics")(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        res["device"].update(busy_s=summ.busy_s, window_s=summ.window_s)
        res["breakdown"] = {
            "device_ops": sorted(([k, v[1]] for k, v in summ.ops.items()),
                                 key=lambda r: -r[1])[:10],
            "idle_gaps": [[n, s] for n, s in summ.idle_gaps]}
    else:
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else nums.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    del prof
    # The program's state is freed before the reference runs.
    del rx, source
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    per_pass = [compare.judge(sky, [p], cfg) for p in passes if p.complete]
    total = compare.merge(per_pass)
    ok, rows = compare.verdict(total, cfg["limits"], len(per_pass))
    rows.append(("pass_errors", len(errors), 0))
    ok = ok and not errors
    for e in errors:
        print(f"portbench: {e}", file=sys.stderr)
    failed = len(errors) + sum(
        1 for n in per_pass if not compare.verdict(n, cfg["limits"], 1)[0])
    res.update(correct=ok, attempted=len(per_pass) + len(errors),
               failed=failed,
               metrics=metrics)
    res["window"] = {k: nums[k] for k in ("superepochs", "signal_s",
                                          "wall_s")}
    res["window"].update(passes=len(passes), kernel_launches=launches,
                         cpu_s=cpu_s, stage_s=stage_seconds(watch),
                         profiler_start_s=prof_start_s)
    res["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return res, rows


def device_info(dev, peak: int) -> dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak)}


def main(argv=None) -> int:
    args = parse(argv)
    # Every kernel and compile cache inside the checkout, at fixed paths,
    # set before the first CUDA call reads them.
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", "portbench_cache", sub)
    import torch

    bench = plan.load_bench()
    cell = plan.plan(bench, args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device: this benchmark measures the "
              "card and does not fall back to the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    res, rows = run(args, "cuda", bench=bench)
    found = guard.loaded(REFUSED)
    if found:
        print(f"portbench: refused modules loaded: {found}", file=sys.stderr)
        return 3
    for k, v, lim in rows:
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    checks = res.pop("checks")
    res["checks"] = checks                       # the last key
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
