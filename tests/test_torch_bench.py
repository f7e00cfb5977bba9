"""The port's benchmark (gnsstpu_torch/bench.py) against the repository's
bench.py, on the CPU.

bench.py's measurements are held to the port's on the same inputs:
bench.py's own code builds each input (its _slope_time and the JAX
package's simulator are recorded instead of timed), and the port's setup
takes the recorded signal.

  * tracking: the 4-channel sky, tap rows, channel constants and state of
    bench_tracking, and a chain of 2 dependent calls of 6 blocks each
    (bench.py's rebase, then the tracker): the reference's fused Pallas
    tracker in interpret mode against the port's fused tracker on K1's
    plain twin, at tests/test_track_kernel.py's tolerances (the carrier
    phase's, one LSB step flip per block, over both calls);
  * acquisition: bench_acquisition's sky, windows, Doppler grid and code
    spectra exactly, and each window's cube maximum against the
    reference's acquire_cube (its exact Stockham FFT on the CPU) within
    rtol 1e-4 (two f32 FFT algorithms);
  * _StageCollector's breakdown of one telemetry stream, equal;
  * bench_manager at 2 s of signal (4 channels, 100 ms epochs x 2, the
    navigator off), host-fed and device-resident: bench.py's key set;
  * main's JSON line at stubbed sizes: bench.py's keys.

The port timed on the card is chip_smoke.py's phase 37.
"""

import ast
import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

import bench as jbench
import gnsstpu.sim
from gnsstpu.config import SignalConfig, TrackConfig
from gnsstpu.tracking import fused as jfused
from gnsstpu_torch import bench as tbench
from gnsstpu_torch.device import u32_numpy
from gnsstpu_torch.ops import track_kernel as tk
from gnsstpu_torch.tracking.fused import fused_tap_rows
from test_torch_track_kernel import _compare
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import to_port

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
TRK = TrackConfig(dll_bw=1.0, el_spacing=0.3)
TSIG, TTRK = to_port(SIG), to_port(TRK)
BENCH_PY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench.py")


def _dict_keys(node: ast.Dict) -> list:
    return [k.value for k in node.keys]


@functools.lru_cache(maxsize=None)
def _reference_keys() -> dict:
    """bench.py's result keys, read from its source: bench_manager's
    return, bench_acquisition's return, main's JSON line and its extra."""
    tree = ast.parse(open(BENCH_PY).read())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        if fn.name in ("bench_manager", "bench_acquisition"):
            out[fn.name] = _dict_keys(fn.body[-1].value)
        if fn.name == "main":
            call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                        and getattr(n.func, "attr", "") == "dumps")
            line = call.args[0]
            out["main"] = _dict_keys(line)
            extra = line.values[_dict_keys(line).index("extra")]
            out["main.extra"] = _dict_keys(extra)
    return out


class _Recorded:
    """bench.py's measurement with its timing and simulator recorded:
    `slope` holds _slope_time's (make_k, state0, args), `sims` each
    simulator's (sats, seed, samples)."""

    def __init__(self, monkeypatch):
        self.slope, self.sims = None, []
        rec = self

        class Sim(gnsstpu.sim.IFSimulator):
            def generate(self, n_ms, *a, **kw):
                out = super().generate(n_ms, *a, **kw)
                rec.sims.append((list(self.sats), self.seed,
                                 np.asarray(out)))
                return out

        def slope(make_k, state0, args, k_lo, k_hi, reps=4):
            rec.slope = (make_k, state0, args)
            return 1.0

        monkeypatch.setattr(gnsstpu.sim, "IFSimulator", Sim)
        monkeypatch.setattr(jbench, "_slope_time", slope)


def _sats_equal(port_sats, ref_sats):
    assert ([dataclasses.asdict(s) for s in port_sats]
            == [dataclasses.asdict(s) for s in ref_sats])


def test_tracking_chain_matches_reference(monkeypatch):
    C, n_blocks, K = 4, 6, 2
    monkeypatch.setattr(jfused, "make_fused_tracker", functools.partial(
        jfused.make_fused_tracker, interpret=True))
    rec = _Recorded(monkeypatch)
    jbench.bench_tracking(SIG, TRK, C=C, n_blocks=n_blocks, k_lo=1,
                          k_hi=K)
    make_k, jstate0, (jchunk, jtab, (jcb, jia)) = rec.slope
    (sats, seed, samples), = rec.sims
    _sats_equal(tbench.tracking_sky(C)[:1], sats)
    assert seed == 2 and samples.shape == ((n_blocks + 3) * 2048, 2)

    st = tbench.tracking_setup(TSIG, TTRK, C, n_blocks, "cpu",
                               samples=samples)
    np.testing.assert_array_equal(st.chunk.numpy(), np.asarray(jchunk))
    np.testing.assert_array_equal(st.tab.numpy(),
                                  fused_tap_rows(np.asarray(jtab)))
    np.testing.assert_array_equal(u32_numpy(st.consts[0]), np.asarray(jcb))
    np.testing.assert_array_equal(st.consts[1].numpy(), np.asarray(jia))
    got0 = st.state0._replace(corr=st.state0.corr._replace(
        carr_phase_u32=torch.as_tensor(u32_numpy(
            st.state0.corr.carr_phase_u32).astype(np.int64))))
    for want, have in zip(jax.tree_util.tree_leaves(jstate0),
                          jax.tree_util.tree_leaves(got0), strict=True):
        np.testing.assert_array_equal(have.numpy(), np.asarray(want))

    ref_state, ref_out = make_k(K)(jstate0, jchunk, jtab, (jcb, jia))
    before = tk.LAUNCHES["track_chunk_fused"]
    got_state, got_out = tbench.tracking_chain(st, st.state0, K)
    assert tk.LAUNCHES["track_chunk_fused"] == before   # the plain twin
    _compare(got_state, got_out, ref_state, ref_out, K * n_blocks)


def test_tracking_rows_past_32_channels():
    """At C > 32 each channel gets its own PRN's row, (i % 32) + 1, from
    the 32 rows built once (bench.py's tile of C // 32 copies gives 32
    rows at C = 48, fewer than its 48 channels; K1 takes one row per
    channel)."""
    st = tbench.tracking_setup(TSIG, TTRK, 48, 1, "cpu")
    rows = fused_tap_rows(tbench.fused_code_table(
        TSIG, TTRK, list(range(1, 33))))
    np.testing.assert_array_equal(st.tab.numpy(),
                                  rows[np.arange(48) % 32])
    assert st.state0.corr.sample_pos.shape == (48,)


def test_acquisition_matches_reference(monkeypatch):
    n = 2
    rec = _Recorded(monkeypatch)
    jbench.bench_acquisition(SIG, k_lo=1, k_hi=n)
    make_k, zero, (jwins, jfd_re, jfd_im, jdopp) = rec.slope
    (sats, seed, samples), = rec.sims
    _sats_equal(tbench.acquisition_sky(), sats)
    assert seed == 7 and samples.shape == ((3 * n + 2) * 2048, 2)

    wins, fd, dopp = tbench.acquisition_setup(TSIG, n, "cpu",
                                              samples=samples)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(jwins))
    np.testing.assert_array_equal(fd.real.numpy(), np.asarray(jfd_re))
    np.testing.assert_array_equal(fd.imag.numpy(), np.asarray(jfd_im))
    np.testing.assert_array_equal(dopp.numpy(), np.asarray(jdopp))
    assert list(fd.shape[:1]) + list(dopp.shape) == [32, 29]

    _, want = make_k(n)(zero, jwins, jfd_re, jfd_im, jdopp)
    got = tbench.search_chain(TSIG, wins, fd, dopp, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def test_acquisition_result_keys():
    res = tbench.bench_acquisition(TSIG, k_lo=1, k_hi=2, device="cpu")
    assert list(res) == _reference_keys()["bench_acquisition"]
    assert res["grid"] == [32, 29, 2048] and res["fft_mode"] == "torch_fft"


def test_stage_collector_matches_reference():
    stream = []
    for k in range(12):
        ems = 500 * k
        for stage, wall in (("track", 0.01 * k), ("upload", 0.002),
                            ("assess", 0.003 + 1e-4 * k)):
            r = {"type": "task_health", "epoch_ms": ems, "stage": stage,
                 "wall_s": wall}
            if stage == "upload" and k % 3:
                r["read_s"] = 0.0005 * k
            stream.append(r)
        if k % 2:
            stream.append({"type": "pvt", "epoch_ms": ems,
                           "lat_deg": 57.0 + k, "lon_deg": 10.0,
                           "h_m": 30.0, "n_sv": 5 + k % 3})
        if k == 4:
            stream.append({"type": "event", "epoch_ms": ems,
                           "what": "ephemeris_decoded"})
    cols = [jbench._StageCollector(), tbench._StageCollector()]
    for c in cols:
        c(stream[0])                   # disabled: ignored
        c.enabled = True
        for r in stream[1:]:
            c(r)
    ref, got = cols
    assert got.rows == ref.rows and got.pvt == ref.pvt
    assert got.eph_events == ref.eph_events == 1
    for lo, hi in ((0, 3000), (3000, 6000), (0, 10 ** 9), (250, 2750)):
        assert got.breakdown(lo, hi) == ref.breakdown(lo, hi)
    assert got.breakdown(3000, 6000)["read"]["n"] == 4


@pytest.mark.parametrize("device_resident", [False, True])
def test_manager_result_keys(device_resident):
    res = tbench.bench_manager(TSIG, seconds=2, n_channels=4, epoch_ms=100,
                               sync_every=2, navigate=False,
                               device_resident=device_resident,
                               device="cpu")
    assert list(res) == _reference_keys()["bench_manager"]
    assert res["engine"] == "fused" and res["navigator"] == {"armed": False}
    assert res["device_resident"] is device_resident
    assert res["measured_ms"] == 1200 and res["link_upload_mbps"] is None
    assert res["live_channels_at_end"] == 3      # the sky's 3 SVs
    assert res["stage_breakdown_s_first_half"]["track"]["n"] == 2


def test_main_json_line(monkeypatch, capsys):
    monkeypatch.setattr(tbench, "TRACKING_RUNS", ((2, 2, 1, 2),
                                                  (3, 2, 1, 2)))
    monkeypatch.setattr(tbench, "bench_acquisition",
                        lambda sig, device: {"search_ms": 1.0,
                                             "cells_per_s": 2})
    monkeypatch.setattr(tbench, "bench_manager",
                        lambda sig, device, device_resident=False:
                        {"device_resident": device_resident})
    res = tbench.main(device="cpu")
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1 and json.loads(line[0]) == res
    keys = _reference_keys()
    assert list(res) == keys["main"]
    extra = res["extra"]
    # bench.py's keys, and the port's two: the device, K1's figures by C.
    assert set(extra) == set(keys["main.extra"]) | {
        "device", "tracking_k1_by_channels"}
    assert extra["device"] == {"name": "cpu", "count": 0}
    assert list(extra["tracking_scaling_channels_rt"]) == ["3", "2"]
    assert set(extra["tracking_k1_by_channels"]["2"]) == {
        "realtime_factor", "ms_per_chained_call", "k1_ms_per_launch"}
    assert extra["acquisition_by_fft_mode"] == {
        "torch_fft": {"search_ms": 1.0, "cells_per_s": 2}}
    assert extra["manager_device_resident"] == {"device_resident": True}
    assert res["metric"] == "gps_l1_12ch_tracking_realtime_factor"


class _FakeEvent:
    """A CUDA event stand-in: query() says whether the card has reached
    it when fn() has been queued (`reached`, one value per try)."""

    def __init__(self, reached, log, **_):
        self.reached, self.log = reached, log

    def record(self):
        self.log.append("record")

    def query(self):
        return self.reached.pop(0)

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 3.0


@pytest.mark.parametrize("reached,spins", [([False], [50_000_000]),
                                           ([True, False],
                                            [50_000_000, 200_000_000]),
                                           ([True] * 3, None)])
def test_timed_s_keeps_fn_queued_behind_the_spin(monkeypatch, reached,
                                                 spins):
    log, slept = [], []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda **kw: _FakeEvent(reached, log, **kw))
    monkeypatch.setattr(torch.cuda, "_sleep", slept.append)
    calls = []
    fn = functools.partial(calls.append, 1)
    dev = torch.device("cuda")
    if spins is None:             # the dispatch outlasts every spin
        with pytest.raises(RuntimeError, match="outlasted a spin"):
            tbench._timed_s(fn, dev, tries=3)
        assert len(calls) == 3 and slept == [50_000_000 * 4 ** i
                                             for i in range(3)]
        return
    assert tbench._timed_s(fn, dev) == pytest.approx(3e-3)
    assert slept == spins and len(calls) == len(spins)
