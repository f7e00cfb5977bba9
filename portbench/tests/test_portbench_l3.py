"""Runs on the card (marker `cuda`; skipped on a host without one):
    python3 -m pytest -m cuda portbench/tests/test_portbench_l3.py
A short traced run of the GLONASS L3OC cell with the program's tracing
on (portbench/spans.py::traced_run): it is correct, its line reports the
cell's per-layer metrics, every search span says it summed each
satellite's pilot and data powers, each cold search on the host
correlated the whole bank of 63 codes and each search on the card's chunk
only the pilot and data rows of the PRNs it may hand over (2 a PRN: 4
while the 8 satellites are tracked and the 2 absent PRNs are wanted, more
if a lock drops, never the bank), and K3's CUDA
events (the superepoch spans' k3_device_ns over k3_launches) give a mean
time per launch within 5% of the profiler's for the same window."""

import argparse

import pytest

from portbench import plan, spans

CELL = "glonass_l3oc_12ch.hostfed_9s"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "pytest -m cuda portbench/tests/test_portbench_l3.py")


@pytest.mark.cuda
def test_k3_events_agree_with_the_profiler(card):
    cell = plan.plan(plan.load_bench(), CELL)
    args = argparse.Namespace(workload=CELL, seed=2147483701, seconds=12.0,
                              trace=1)
    res, recs, seen = spans.traced_run(args, "cuda")
    assert res["correct"] and res["attempted"] >= 1, res["checks"]
    assert {m["name"] for m in cell.per_layer} <= set(res["metrics"])
    host = [s["counters"] for s in recs if s["name"] == "acq.host_search"]
    chunk = [s["counters"] for s in recs if s["name"] == "acq.chunk_search"]
    assert host and all(c == {"codes": 63, "combined": 1} for c in host)
    assert chunk and all(c["combined"] == 1 and c["codes"] % 2 == 0
                         and 4 <= c["codes"] < 63 for c in chunk), chunk
    assert any(c["codes"] == 4 for c in chunk), chunk
    sup = [s["counters"] for s in recs if s["name"] == "superepoch"]
    n = sum(c.get("k3_launches", 0) for c in sup)
    ns = sum(c.get("k3_device_ns", 0) for c in sup)
    w0, w1 = seen["window"]
    prof = [b - a for name, a, b in seen["device"]
            if cell.kernel["symbol"] in name and a >= w0 and b <= w1]
    assert n > 0 and prof
    assert abs((ns / n) / (sum(prof) / len(prof)) - 1.0) <= 0.05, (
        ns / n, sum(prof) / len(prof), n, len(prof))
