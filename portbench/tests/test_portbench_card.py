"""Runs on the card (marker `cuda`; skipped on a host without one):
    python3 -m pytest -m cuda portbench/tests/test_portbench_card.py
A short run of each cell through the command BENCHMARK.json names, one
of them traced: it exits 0, prints one result line that is correct and
names the card."""

import json
import subprocess
import sys

import pytest

from portbench import plan

CELLS = [w["name"] for w in plan.load_bench()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "pytest -m cuda portbench/tests/test_portbench_card.py")


def _run(cell: str, trace: int) -> dict:
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483690", "--seconds", "4", "--trace", str(trace)],
        cwd=plan.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(card, cell):
    res = _run(cell, 0)
    assert res["correct"] and res["attempted"] >= 1
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"
    assert {m["name"] for m in plan.load_bench()["end_to_end"]} <= set(
        res["metrics"])
    assert res["metrics"]["device_ms_per_signal_s"]["value"] > 0


@pytest.mark.cuda
def test_traced_run_reads_the_device(card):
    res = _run(CELLS[0], 1)
    assert res["correct"]
    assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
    assert {"k1.roofline_pct", "live.realtime_factor"} <= set(
        res["metrics"])
    assert res["breakdown"]["device_ops"] and res["breakdown"]["idle_gaps"]
