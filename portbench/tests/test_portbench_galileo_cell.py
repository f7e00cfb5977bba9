"""The Galileo E1B cell on the CPU: BENCHMARK.json plans it from the
checkout's files (the configuration, the mix, kernels/K2.json and K2's
two readers); K2's least work at this configuration is the flops-bound
0.00827 ms of 22 operations a sample; the plain reference in the
program's place is correct and one precision step down is not; and a
flipped I/NAV symbol, a Doppler one bin off and a fix a chip's range off
each fail the comparison."""

import copy
import types

import pytest

from portbench import control, peaks, plan
from portbench.gen import sky as skymod
from portbench.reference import compare

CELL = "galileo_e1b_12ch.hostfed_20s"
BENCH = plan.load_bench()
DATA = plan.HERE / "tests" / "data"
#: c over the E1B chip rate (1.023 Mcps), as a GPS chip's.
CHIP_M = 293.05


def _planned():
    return plan.plan(BENCH, CELL)


def test_the_repos_benchmark_plans_the_galileo_cell():
    cell = _planned()
    assert cell.chips == 1
    assert cell.config["name"] == "galileo_e1b_12ch"
    assert cell.config["signal"]["signal"] == "galileo_e1b"
    assert cell.kernel["name"] == "K2"
    assert cell.kernel["counter"] == "track_chunk_boc_fused"
    assert cell.kernel["symbol"] == "track_boc_fused_kernel"
    assert [m["name"] for m in cell.per_layer] == ["k2.roofline_pct",
                                                   "k2.busy_pct"]
    assert {m["name"] for m in cell.end_to_end} == {
        "device_ms_per_signal_s", "setup_s"}
    assert ((plan.HERE / "traffic" / "hostfed_20s.json").read_bytes()
            == (DATA / "traffic" / "galileo_20s.json").read_bytes())
    draft = plan.load_json(DATA / "configs" / "galileo_e1b_12ch.json")
    kept = set(draft) - {"source", "assumed"}
    assert {k: cell.config[k] for k in kept} == {k: draft[k] for k in kept}
    assert cell.config["reduced"] == []
    entry = {c["name"]: c for c in BENCH["configs"]}["galileo_e1b_12ch"]
    assert entry["reduced"] == [] and "GALILEO/E1" in entry["source"]


def test_k2s_least_work_is_flops_bound_at_the_cells_shape():
    cell = _planned()
    n_bytes, flops = peaks.launch_work(cell.kernel, cell.config)
    assert flops == 22.0 * 12 * 125 * 16800
    assert flops / peaks.F32_FLOPS > n_bytes / peaks.HBM_BPS
    assert peaks.bound_s(n_bytes, flops) == pytest.approx(8.27e-6,
                                                          rel=0.01)


def _trace(k2, busy_s=2.0):
    return types.SimpleNamespace(busy_s=busy_s, kernel=lambda sym: (
        k2 if sym == "track_boc_fused_kernel" else None))


@pytest.mark.parametrize("name", ["k2.roofline_pct", "k2.busy_pct"])
def test_k2_readers_read_k2_and_nothing_without_it(name):
    """Each reader reads K2's launches; a trace without them (a program
    that never ran K2) gives nothing rather than raising."""
    cell = _planned()
    read = plan.reader(name)
    ctx = {"config": cell.config, "kernels": {"K2": cell.kernel},
           "trace": _trace((1000, 0.69))}
    bound = peaks.bound_s(*peaks.launch_work(cell.kernel, cell.config))
    want = {"k2.roofline_pct": 100.0 * bound / 0.69e-3,
            "k2.busy_pct": 100.0 * 0.69 / 2.0}[name]
    assert read(ctx) == pytest.approx(want)
    assert read(dict(ctx, trace=_trace(None))) is None
    assert read(dict(ctx, trace=_trace((0, 0.0)))) is None
    assert read(dict(ctx, kernels={})) is None


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5])
def test_reference_correct_and_control_not(seed):
    cell = _planned()
    r = control.readings(cell.config, cell.traffic, seed)
    assert r["stated"][0], r["stated"][1]
    ok, rows = r["control"]
    assert not ok
    failed = {k for k, v, lim in rows if v > lim and k != "passes_judged"}
    assert {"doppler_err_hz", "code_err_m", "eph_errors"} <= failed


def _ideal(seed=11):
    cell = _planned()
    sky = skymod.make_sky(cell.config, cell.traffic, seed)
    p = control.ideal_pass(sky, cell.config, cell.traffic["recording_ms"],
                           "float32", "float64")
    return cell.config, sky, p


def _judge(cfg, sky, p):
    ok, rows = compare.verdict(compare.judge(sky, [p], cfg), cfg["limits"],
                               1)
    return ok, {k: v for k, v, _ in rows}


@pytest.mark.parametrize("fault", ["symbol", "doppler", "fix"])
def test_a_planted_fault_fails_the_galileo_cell(fault):
    cfg, sky, p = _ideal()
    assert _judge(cfg, sky, p)[0]
    bad = copy.deepcopy(p)
    if fault == "symbol":                # one I/NAV symbol, one 4 ms period
        bad.history[sky.prns[0]]["i_p"][0][2000] *= -1
        key, least = "symbol_errors", 1
    elif fault == "doppler":             # one search bin over one epoch
        bad.history[sky.prns[-1]]["carr_doppler"][0][1500:1625] += (
            cfg["acq"]["doppler_step"])
        key, least = "doppler_err_hz", 70.0
    else:                                # one fix a chip's range off
        bad.solutions[3]["x"] += CHIP_M
        key, least = "fix_err_m", 290.0
    ok, nums = _judge(cfg, sky, bad)
    assert not ok and nums[key] >= least, nums
