"""The span probe (portbench/spans.py) on the CPU: its readers on
synthetic spans give the numbers worked by hand and None without their
spans; idle_by_span splits a synthetic window's idle time by the
innermost range; no range of the program counts as device work; a whole
traced run at a test size gives the host-side numbers, and an untraced
one keeps no span."""

import argparse
import types

import pytest

from gnsstpu_torch.runtime.telemetry import Telemetry

from portbench import plan, run, spans, system, trace

BASE = plan.HERE / "tests" / "data"
BENCH = {"workloads": [{"name": "tiny", "config": "gps_tiny",
                        "traffic": "gps_3s", "chips": 1}],
         "configs": [], "per_layer": [], "end_to_end": []}
MS = 1_000_000


def _span(name, t0_ms, t1_ms, **counters):
    return {"name": name, "id": 0, "parent": None, "se": 0,
            "thread": "MainThread", "t0_ns": t0_ms * MS, "t1_ns": t1_ms * MS,
            "counters": counters}


#: 20 superepochs of 100..290 ms (p95 by numpy's linear rule: 280.5),
#: each with 2 ms of nav.decode and 7 ms of nav.solve, and 1.5 ms of K1.
SPANS = ([_span("superepoch", 0, 100 + 10 * i, k1_device_ns=1_500_000)
          for i in range(20)]
         + [_span("nav.decode", 0, 2) for _ in range(20)]
         + [_span("nav.solve", 0, 7) for _ in range(20)])


@pytest.mark.parametrize("name,read,value", [
    ("live.superepoch_latency_ms_p95",
     lambda s: spans.superepoch_latency_ms_p95(s), 280.5),
    ("navigator.decode_pct",
     lambda s: spans.span_pct(s, "nav.decode", 4.0), 1.0),
    ("navigator.solve_pct",
     lambda s: spans.span_pct(s, "nav.solve", 4.0), 3.5),
    ("k1.event_ms_per_signal_s",
     lambda s: spans.k1_event_ms_per_signal_s(s, 15.0), 2.0),
    ("device.idle_unattributed_pct",
     lambda s: spans.idle_unattributed_pct(
         {"unattributed": 0.2, "supervise": 1.0} if s else {}, 4.0), 5.0),
])
def test_readers(name, read, value):
    assert read(SPANS) == pytest.approx(value), name
    assert read([]) is None, name


def test_idle_by_span():
    """Window 0-100 ns; device work 10-20 and 50-60 (overlapping 55-58);
    supervise 0-45 holding nav.poll 5-30, dispatch 45-52: idle 0-10 in
    nav.poll 5-10 and supervise 0-5, 20-45 in nav.poll to 30 and
    supervise after, 45-50 in dispatch, 60-100 unattributed."""
    device = [("k", 10, 20), ("k", 50, 60), ("memcpy", 55, 58)]
    ranges = [("gnss.supervise", 0, 45), ("gnss.nav.poll", 5, 30),
              ("gnss.dispatch", 45, 52)]
    got = spans.idle_by_span(device, ranges, 0, 100)
    want = {"supervise": 5 + 15, "nav.poll": 5 + 10, "dispatch": 5,
            "unattributed": 40}
    assert got == pytest.approx({k: v * 1e-9 for k, v in want.items()})
    assert sum(got.values()) == pytest.approx(80e-9)
    assert spans.idle_by_span([], ranges, 0, 100) == {}


@pytest.mark.parametrize("activity,work", [
    ("kernel", True), ("gpu_memcpy", True), ("gpu_memset", True),
    ("gpu_user_annotation", False), ("user_annotation", False),
    ("cpu_op", False)])
def test_program_ranges_are_not_device_work(activity, work):
    """A gnss.* range on either timeline is no device work for busy_s,
    summarize and idle_by_span; a kernel of the same name would be."""
    ev = types.SimpleNamespace(activity_type=lambda: activity,
                               device_type=lambda: "DeviceType.CUDA")
    assert trace._is_work(ev, "gnss.dispatch") is work


def _args(trace_flag):
    return argparse.Namespace(workload="tiny", seed=2 ** 31 + 77,
                              seconds=0.01, trace=trace_flag)


def test_traced_run_gives_the_host_numbers(monkeypatch):
    """One whole pass in the window, traced on the CPU: the superepoch
    latency and the navigator's shares read; no K1 events, no device
    work, so the device's numbers are None."""
    monkeypatch.setattr(system.StopAt, "poll", lambda self: [])
    res, got, seen = spans.traced_run(_args(0), "cpu", base=BASE,
                                      bench=BENCH)
    assert res["correct"] and res["window"]["passes"] == 1
    assert got and {"superepoch", "dispatch", "harvest.wait", "supervise",
                    "nav.decode", "nav.solve"} <= {s["name"] for s in got}
    assert any(r[0] == "gnss.supervise" for r in seen["ranges"])
    kernel = plan.load_json(BASE / "kernels" / "K1.json")
    out = spans.report(res, got, seen, kernel)
    m = out["metrics"]
    assert 0 < m["live.superepoch_latency_ms_p95"] < 1e3 * res["window"][
        "wall_s"]
    assert 0 < m["navigator.decode_pct"] < 100
    assert 0 < m["navigator.solve_pct"] < 100
    assert m["k1.event_ms_per_signal_s"] is None
    assert m["device.idle_unattributed_pct"] is None
    for span_name, stage in (("supervise", "assess"), ("dispatch", "track"),
                             ("harvest.wait", "readback"),
                             ("nav.poll", "pvt")):
        assert out["span_s"][span_name] == pytest.approx(
            out["stage_s"][stage], rel=1e-3, abs=1e-5), span_name


def test_untraced_run_keeps_no_span(monkeypatch):
    monkeypatch.setattr(system.StopAt, "poll", lambda self: [])
    made = []

    def telemetry(**kw):
        made.append(Telemetry(**kw))
        return made[-1]

    monkeypatch.setattr(system, "Telemetry", telemetry)
    res, _ = run.run(_args(0), "cpu", base=BASE, bench=BENCH)
    assert res["correct"] and len(made) == 2
    assert all(not t.trace and t.spans == [] for t in made)
