"""A whole run of the harness on the CPU at a test size, skipping only its
look for a card: sound, it comes out correct; with the timed path broken
underneath, it comes out not correct, once for each fault the cells can
have, and for the navigator's fixes, a satellite's pseudoranges a chip
off, a fix a chip's range off and a navigator that stops solving. (The cells run on one
card, so there is no exchange between cards to leave out.)"""

import argparse

import numpy as np
import pytest

from gnsstpu_torch.runtime import manager as mgr_mod
from gnsstpu_torch.runtime import navigator as nav_mod

from portbench import plan, run, system

BASE = plan.HERE / "tests" / "data"
BENCH = {"workloads": [{"name": "tiny", "config": "gps_tiny",
                        "traffic": "gps_3s", "chips": 1},
                       {"name": "fixes", "config": "gps_fix_tiny",
                        "traffic": "gps_22s", "chips": 1}],
         "configs": [], "per_layer": [],
         "end_to_end": [{"name": n, "unit": u} for n, u in (
             ("realtime_factor", "s/s"), ("superepoch_ms_p95", "ms"),
             ("setup_s", "s"))]}


def _run(monkeypatch, seed=2 ** 31 + 77, workload="tiny"):
    # One whole pass in the window: the pass in flight is not cut.
    monkeypatch.setattr(system.StopAt, "poll", lambda self: [])
    args = argparse.Namespace(workload=workload, seed=seed, seconds=0.01,
                              trace=0)
    res, rows = run.run(args, "cpu", base=BASE, bench=BENCH)
    return res, {k: v for k, v, _ in rows}


def _on_readback(monkeypatch, fault):
    """fault(manager, streams, stats, n) edits the n-th superepoch's
    decoded readback of a manager in place, as if the device produced
    it."""
    orig = mgr_mod.ChannelManager._decode_readback

    def wrapped(self, raw):
        streams, stats = orig(self, raw)
        streams, stats = streams.copy(), stats.copy()
        self._fault_n = getattr(self, "_fault_n", 0) + 1
        fault(self, streams, stats, self._fault_n)
        return streams, stats

    monkeypatch.setattr(mgr_mod.ChannelManager, "_decode_readback", wrapped)


def test_sound_run_is_correct(monkeypatch):
    res, nums = _run(monkeypatch)
    assert res["correct"], nums
    assert res["attempted"] == 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"realtime_factor", "superepoch_ms_p95",
                                   "setup_s"}


def test_tracking_step_that_returns_its_state_unchanged(monkeypatch):
    make = mgr_mod.make_engine

    def frozen_engine(*a, **k):
        eng = make(*a, **k)
        make_step = eng.make_step

        def step_of(n_blocks):
            step = make_step(n_blocks)

            def frozen(win, bank, state):
                return state, step(win, bank, state)[1]
            return frozen
        eng.make_step = step_of
        return eng

    monkeypatch.setattr(mgr_mod, "make_engine", frozen_engine)
    res, nums = _run(monkeypatch)
    assert not res["correct"], nums


def test_half_of_the_channels_left_out(monkeypatch):
    def drop_half(m, streams, stats, n):
        C = streams.shape[2]
        streams[:, :, C // 2:, :2] = 0.0       # prompts I and Q
        stats[:, C // 2:, :] = 0.0

    _on_readback(monkeypatch, drop_half)
    res, nums = _run(monkeypatch)
    assert not res["correct"], nums


def test_a_bit_flipped_where_it_is_produced(monkeypatch):
    def flip(m, streams, stats, n):
        if n == 3:                             # after the settle time
            streams[0, 100:120, 0, m._S_IP] *= -1.0

    _on_readback(monkeypatch, flip)
    res, nums = _run(monkeypatch)
    assert not res["correct"] and nums["symbol_errors"] >= 20, nums


def test_a_doppler_one_bin_off_where_it_is_produced(monkeypatch):
    def shift(m, streams, stats, n):
        if n == 3:
            streams[:, :, 0, m._S_DOPP] += 250.0

    _on_readback(monkeypatch, shift)
    res, nums = _run(monkeypatch)
    assert not res["correct"] and nums["doppler_err_hz"] > 100, nums


def _run_to_fixes(monkeypatch):
    """A 22 s pass, long enough for the ephemerides and a few fixes (the
    untimed warm pass, which only pays first calls, left out here)."""
    run_pass = system.Receiver.run_pass
    monkeypatch.setattr(system.Receiver, "run_pass", lambda self, i, *a: (
        None if i < 0 else run_pass(self, i, *a)))
    return _run(monkeypatch, seed=2 ** 31 + 99, workload="fixes")


def _on_navigate(monkeypatch, fault):
    """fault(call index, abs_sample, solution) breaks the navigator's
    solves where they are produced."""
    navigate = nav_mod.pvt.navigate
    calls = []

    def wrapped(*a, **k):
        abs_sample = np.array(k["abs_sample"], np.float64)
        sol = navigate(*a, **dict(k, abs_sample=fault(
            len(calls), abs_sample, None)))
        fault(len(calls), None, sol)
        calls.append(1)
        return sol

    monkeypatch.setattr(nav_mod.pvt, "navigate", wrapped)


def test_sound_run_reaches_its_fixes(monkeypatch):
    res, nums = _run_to_fixes(monkeypatch)
    assert res["correct"], nums
    assert nums["passes_no_fix"] == 0 and nums["fixes_missing"] == 0


def test_pseudoranges_a_chip_off_where_they_are_produced(monkeypatch):
    """The program's residual screen rejects every fix of a satellite
    set with one range a chip off: the fixes due go missing."""
    fs, fc = 2048000.0, 1023000.0

    def chip_off(n, abs_sample, sol):
        if abs_sample is not None:
            abs_sample[0] += fs / fc          # one satellite, one chip
        return abs_sample

    _on_navigate(monkeypatch, chip_off)
    res, nums = _run_to_fixes(monkeypatch)
    assert not res["correct"] and nums["fixes_missing"] > 0, nums


def test_a_fix_a_chips_range_off_where_it_is_produced(monkeypatch):
    def moved(n, abs_sample, sol):
        if sol is not None:
            sol.x[sol.valid] += 293.05        # c / 1.023 MHz
        return abs_sample

    _on_navigate(monkeypatch, moved)
    res, nums = _run_to_fixes(monkeypatch)
    assert not res["correct"] and nums["fix_err_m"] > 250.0, nums


def test_a_navigator_that_stops_solving(monkeypatch):
    """Its solves yield no fix: every fix due is missing. (At the cells'
    size a navigator that stops after its first solve reads the same way;
    this pass is too short to owe more fixes than a first solve gives.)"""
    def stop(n, abs_sample, sol):
        if sol is not None:
            sol.valid[:] = False
        return abs_sample

    _on_navigate(monkeypatch, stop)
    res, nums = _run_to_fixes(monkeypatch)
    assert not res["correct"] and nums["fixes_missing"] > 0, nums
