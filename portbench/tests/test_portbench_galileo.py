"""Runs on the card (marker `cuda`; skipped on a host without one):
    python3 -m pytest -m cuda portbench/tests/test_portbench_galileo.py
A short traced run of the Galileo E1B cell with the program's tracing on
(portbench/spans.py::traced_run): it is correct and its line reports
k2.roofline_pct and k2.busy_pct; each cold search on the host correlated
the whole bank of 50 E1B codes and each search on the card's chunk only
the rows of the PRNs it may hand over (2 while the 8 satellites are
tracked and the 2 absent PRNs are wanted, more if a lock drops, never
the bank); and K2's CUDA events (the superepoch spans' k2_device_ns over
k2_launches) give a mean time per launch within 5% of the profiler's for
the same window."""

import argparse

import pytest

from portbench import plan, spans

CELL = "galileo_e1b_12ch.hostfed_20s"
E1B_CODES = 50


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "pytest -m cuda portbench/tests/test_portbench_galileo.py")


@pytest.mark.cuda
def test_k2_events_agree_with_the_profiler(card):
    cell = plan.plan(plan.load_bench(), CELL)
    args = argparse.Namespace(workload=CELL, seed=2147483711, seconds=12.0,
                              trace=1)
    res, recs, seen = spans.traced_run(args, "cuda")
    assert res["correct"] and res["attempted"] >= 1, res["checks"]
    assert {"k2.roofline_pct", "k2.busy_pct"} <= set(res["metrics"])
    assert 0 < res["metrics"]["k2.roofline_pct"]["value"] <= 105
    host = [s["counters"] for s in recs if s["name"] == "acq.host_search"]
    chunk = [s["counters"] for s in recs if s["name"] == "acq.chunk_search"]
    assert host and all(c["codes"] == E1B_CODES for c in host), host
    assert chunk and all(1 <= c["codes"] < E1B_CODES
                         and c["combined"] == 0 for c in chunk), chunk
    assert any(c["codes"] == 2 for c in chunk), chunk
    sup = [s["counters"] for s in recs if s["name"] == "superepoch"]
    assert not any("k1_launches" in c or "k3_launches" in c for c in sup)
    n = sum(c.get("k2_launches", 0) for c in sup)
    ns = sum(c.get("k2_device_ns", 0) for c in sup)
    w0, w1 = seen["window"]
    prof = [b - a for name, a, b in seen["device"]
            if cell.kernel["symbol"] in name and a >= w0 and b <= w1]
    assert n > 0 and prof
    assert abs((ns / n) / (sum(prof) / len(prof)) - 1.0) <= 0.05, (
        ns / n, sum(prof) / len(prof), n, len(prof))
