"""The port's end-to-end examples (examples/torch_e2e_*.py) against the
reference's (examples/e2e_*.py), on the CPU.

  * The scenarios. Where a reference example keeps its constants at
    module level (e2e_gps_l1.py:34-47, e2e_position_fix.py:32-52,
    e2e_joint_fix.py:29-31), that file is loaded with importlib (its main
    is never called) and the port example's constants must equal them.
    Where it builds them inside main, the test builds them as the lines
    it names do, with gnsstpu, and the port example's must be equal:
    e2e_gps_l1.py:51-61 and :76, e2e_position_fix.py:56-70,
    e2e_glonass_fix.py:41-65, e2e_joint_fix.py:52-88 and :99-117,
    e2e_multichip.py:37-59.
  * The GPS example's chain at 600 ms of its signal (one reference
    simulator draw, seed 13, fed to both packages): acquisition identical
    (detected PRNs, code phase and Doppler bin); tracking with the
    example's 250 ms chunks, the port's 'fused' (kernel K1's plain twin)
    against the reference's scan in 'table' mode (the engine whose
    1/64-chip rows K1 shares) at tests/test_torch_driver.py's
    tolerances: accumulators rtol 2e-3 / atol 2, carrier Doppler 0.05 Hz,
    abs_sample within 5e-4 chip after the port's half-slip term.
  * The position-fix configuration at 1 s of its signal: run_receiver of
    both packages (the reference's driver switched to 'table' as in
    tests/test_torch_receiver.py) hands over the same channels, with the
    same acquisition and tracks at the same tolerances.
  * In processes whose import system refuses jax, jaxlib and gnsstpu
    (chip_smoke.EXAMPLE_BOOT, which phase 39 runs on the card), each
    example imports cleanly and its main() asks for the card: without
    one it raises instead of running on the CPU.
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gnsstpu import config as jcfg
from gnsstpu.acquisition import acquire as jacquire
from gnsstpu.acquisition.search import acq_samples_needed
from gnsstpu.nav import geodesy as jgeodesy
from gnsstpu.nav import lnav as jlnav
from gnsstpu.nav.orbits import satpos as jsatpos
from gnsstpu.nav.types import Ephemeris as JEphemeris
from gnsstpu.runtime import receiver as jrec
from gnsstpu.runtime.sources import ArraySource as JArraySource
from gnsstpu.sim import IFSimulator as JIFSimulator
from gnsstpu.sim import SatParams as JSatParams
from gnsstpu.sim import scenario as jscenario
from gnsstpu.tracking import driver as jdriver
from gnsstpu_torch.acquisition.search import acquire
from gnsstpu_torch.ops import track_kernel as tk
from gnsstpu_torch.runtime import receiver as trec
from gnsstpu_torch.runtime.sources import ArraySource
from gnsstpu_torch.tracking import driver as tdriver
from chip_smoke import EXAMPLE_BOOT, EXAMPLES
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACCS = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l")


def _load(name: str):
    """examples/NAME.py as a module (its main is not called)."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(REPO, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ex():
    """{name: module} of the five port examples and the reference's three
    that keep their constants at module level."""
    mods = {n: _load(n) for n in EXAMPLES}
    for n in ("e2e_gps_l1", "e2e_position_fix", "e2e_joint_fix"):
        mods[n] = _load(n)
    return mods


def _same(port, ref) -> None:
    """port (a gnsstpu_torch value) equals ref (its gnsstpu counterpart):
    dataclasses field by field, arrays exactly, containers item by
    item."""
    if dataclasses.is_dataclass(ref):
        assert type(port).__name__ == type(ref).__name__
        for f in dataclasses.fields(ref):
            _same(getattr(port, f.name), getattr(ref, f.name))
    elif isinstance(ref, dict):
        assert list(port) == list(ref)
        for k in ref:
            _same(port[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _same(a, b)
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(port, ref)
    else:
        assert port == ref, (port, ref)


# --- the scenarios -------------------------------------------------------

def _gps_l1_sat(ref):
    """e2e_gps_l1.py:51-59."""
    rng = np.random.default_rng(5)
    filler = rng.choice([-1.0, 1.0], size=100)
    filler[-2:] = 1.0
    nav = np.concatenate([filler, jlnav.encode_frames(ref.EPH,
                                                      tow0=ref.TOW0)])
    return JSatParams(prn=7, doppler_hz=1836.0, code_phase_chips=412.4,
                      cn0_dbhz=45.0, nav_bits=nav)


def _position_sky(ref):
    """e2e_position_fix.py:56-66: (chosen, elevations)."""
    ephs = []
    for k in range(24):
        d = dict(ref.BASE_EPH)
        d["M_0"] = (ref.BASE_EPH["M_0"] + 2.1 * k) % (2 * np.pi) - np.pi
        d["omega_0"] = ((ref.BASE_EPH["omega_0"] + 1.1 * k) % (2 * np.pi)
                        - np.pi)
        d["i_0"] = 0.93 + 0.03 * (k % 3)
        ephs.append(JEphemeris(**d))
    pos, _ = jsatpos(ref.TOW0_6S * 6.0, ephs)
    _, el, _ = jgeodesy.topocent(ref.RECV_ECEF, pos - ref.RECV_ECEF)
    return {int(k) + 1: ephs[k] for k in np.argsort(-el)[:6]}, el


def _position_sats(ref, chosen):
    """e2e_position_fix.py:68-69."""
    return jscenario.build_scenario(ref.SIG, chosen, ref.RECV_ECEF,
                                    ref.TOW0_6S,
                                    duration_s=ref.N_MS / 1000.0,
                                    cn0_dbhz=47.0)


def _glonass_scenario():
    """e2e_glonass_fix.py:41-65: (constants, sats, qephs, cfg)."""
    recv = np.array([3427947.0, 603774.0, 5326967.0])
    tb = 675
    t0 = tb * 60 + 30.0
    n_ms = 10000
    sig = jcfg.SignalConfig(signal="glonass_l1of", if_freq=0.0, fs=4.096e6,
                            code_freq=0.511e6, code_length=511,
                            fdma_step=562.5e3, complex_iq=True)
    gephs = jscenario.make_glonass_constellation(recv, tb, n=6)
    sats, qephs = jscenario.build_scenario_glonass(
        sig, gephs, recv, t0, duration_s=n_ms / 1000.0, cn0_dbhz=48.0,
        n_strings=4)
    cfg = jcfg.ReceiverConfig(
        signal=sig,
        acq=jcfg.AcqConfig(doppler_band=14e3, coherent_ms=2, threshold=2.5),
        track=jcfg.TrackConfig(dll_bw=1.0, pll_bw=25.0, fll_bw=250.0,
                               aid_div=1602e6 / 0.511e6),
        nav=jcfg.NavConfig(sol_period_ms=500, elevation_mask_deg=10.0,
                           use_tropo=False),
        n_channels=6, ms_to_process=n_ms)
    consts = {"RECV": recv, "TB": tb, "T_START": t0, "N_MS": n_ms,
              "SEED": 31, "SIG": sig}
    return consts, sats, qephs, cfg


def _joint_gps(ref):
    """e2e_joint_fix.py:52-88: (sig, sats, cfg) of the GPS run."""
    base = dict(
        t_oc=266400.0, a_f0=2.45e-4, a_f1=-3.2e-12, a_f2=0.0,
        T_GD=-4.656e-9, sqrtA=5153.712, e=0.0123456, M_0=1.23456,
        deltan=4.2e-9, omega=-1.87654, omega_0=-2.0312,
        omegaDot=-8.1e-9, i_0=0.96123, iDot=4.0e-10, t_oe=266400.0,
        C_uc=-6.7e-7, C_us=8.1e-6, C_rc=221.5625, C_rs=-12.8125,
        C_ic=-7.45e-8, C_is=1.12e-7, valid=True)
    cand = []
    for k in range(24):
        d = dict(base)
        d["M_0"] = (base["M_0"] + 2.1 * k) % (2 * np.pi) - np.pi
        d["omega_0"] = (base["omega_0"] + 1.1 * k) % (2 * np.pi) - np.pi
        d["i_0"] = 0.93 + 0.03 * (k % 3)
        cand.append(JEphemeris(**d))
    pos, _ = jsatpos(266400.0, cand)
    _, el, _ = jgeodesy.topocent(ref.RECV, pos - ref.RECV)
    ephs = {int(k) + 1: cand[k] for k in np.argsort(-el)[:3]}
    sig = jcfg.SignalConfig(if_freq=0.0, fs=ref.FS, complex_iq=True)
    sats = jscenario.build_scenario(sig, ephs, ref.RECV, 44400,
                                    duration_s=ref.N_MS / 1000.0,
                                    cn0_dbhz=47.0)
    cfg = jcfg.ReceiverConfig(
        signal=sig,
        acq=jcfg.AcqConfig(doppler_band=10e3, coherent_ms=2, threshold=2.4,
                           prn_list=tuple(ephs), fine_doppler_ms=10),
        track=jcfg.TrackConfig(dll_bw=1.0, pll_bw=25.0, fll_bw=250.0),
        nav=jcfg.NavConfig(sol_period_ms=500, elevation_mask_deg=10.0,
                           use_tropo=False),
        n_channels=3)
    return sig, sats, cfg


def _joint_glonass(ref):
    """e2e_joint_fix.py:99-117: (sig, sats, cfg) of the GLONASS run."""
    sig = jcfg.SignalConfig(signal="glonass_l1of", if_freq=0.0, fs=ref.FS,
                            code_freq=0.511e6, code_length=511,
                            fdma_step=562.5e3, complex_iq=True)
    tb = 675
    gephs = jscenario.make_glonass_constellation(ref.RECV, tb, n=3)
    sats, qephs = jscenario.build_scenario_glonass(
        sig, gephs, ref.RECV, tb * 60 + 30.0,
        duration_s=ref.N_MS / 1000.0, cn0_dbhz=48.0, n_strings=8)
    cfg = jcfg.ReceiverConfig(
        signal=sig,
        acq=jcfg.AcqConfig(doppler_band=14e3, coherent_ms=2, threshold=2.5,
                           prn_list=tuple(qephs), fine_doppler_ms=10),
        track=jcfg.TrackConfig(dll_bw=1.0, pll_bw=25.0, fll_bw=250.0,
                               aid_div=1602e6 / 0.511e6),
        nav=jcfg.NavConfig(sol_period_ms=500, elevation_mask_deg=10.0,
                           use_tropo=False),
        n_channels=3)
    return sig, sats, cfg


def test_gps_l1_scenario_matches_reference(ex):
    port, ref = ex["torch_e2e_gps_l1"], ex["e2e_gps_l1"]
    for name in ("SIG", "ACQ", "TRK", "EPH"):
        _same(getattr(port, name), to_port(getattr(ref, name)))
    assert port.TOW0 == ref.TOW0
    # e2e_gps_l1.py:56, :60 and :76: 21 s, seed 13, 250 ms chunks.
    assert (port.N_MS, port.SEED, port.CHUNK_MS) == (21000, 13, 250)
    _same(port.satellite(), to_port(_gps_l1_sat(ref)))


def test_position_fix_scenario_matches_reference(ex):
    port, ref = ex["torch_e2e_position_fix"], ex["e2e_position_fix"]
    assert port.BASE_EPH == ref.BASE_EPH
    np.testing.assert_array_equal(port.RECV_ECEF, ref.RECV_ECEF)
    assert (port.TOW0_6S, port.N_MS) == (ref.TOW0_6S, ref.N_MS)
    for name in ("SIG", "CFG"):
        _same(getattr(port, name), to_port(getattr(ref, name)))
    assert port.SEED == 21                      # e2e_position_fix.py:70
    chosen, el = _position_sky(ref)
    got, got_el = port.choose_sky()
    np.testing.assert_array_equal(got_el, el)
    _same(got, {p: to_port(e) for p, e in chosen.items()})
    sats = port.build_scenario(port.SIG, got, port.RECV_ECEF, port.TOW0_6S,
                               duration_s=port.N_MS / 1000.0, cn0_dbhz=47.0)
    _same(sats, [to_port(s) for s in _position_sats(ref, chosen)])


def test_glonass_fix_scenario_matches_reference(ex):
    port = ex["torch_e2e_glonass_fix"]
    consts, sats, qephs, cfg = _glonass_scenario()
    for name, want in consts.items():
        _same(getattr(port, name), to_port(want))
    _same(port.CFG, to_port(cfg))
    got_sats, got_qephs = port.scenario()
    _same(got_sats, [to_port(s) for s in sats])
    _same(got_qephs, {p: to_port(e) for p, e in qephs.items()})


def test_joint_fix_scenario_matches_reference(ex):
    port, ref = ex["torch_e2e_joint_fix"], ex["e2e_joint_fix"]
    np.testing.assert_array_equal(port.RECV, ref.RECV)
    assert (port.N_MS, port.FS) == (ref.N_MS, ref.FS)
    # e2e_joint_fix.py:160-162: the joint solve's NavConfig and epochs.
    _same(port.NAV, to_port(jcfg.NavConfig(
        sol_period_ms=500, elevation_mask_deg=10.0, use_tropo=False)))
    assert port.N_EPOCHS == 10
    for got, want in ((port.gps_setup(), _joint_gps(ref)),
                      (port.glonass_setup(), _joint_glonass(ref))):
        _same(got[0], to_port(want[0]))
        _same(got[1], [to_port(s) for s in want[1]])
        _same(got[2], to_port(want[2]))


def test_multichip_scenario_matches_reference(ex):
    """e2e_multichip.py:41-59 at its default of 2 devices."""
    port = ex["torch_e2e_multichip"]
    sig = jcfg.SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
    prns = (2, 5, 9)
    sats = [JSatParams(prn=p, doppler_hz=300.0 * (p - 5),
                       code_phase_chips=211.5 * p, cn0_dbhz=47.0)
            for p in prns]
    cfg = jcfg.ReceiverConfig(
        signal=sig,
        acq=jcfg.AcqConfig(doppler_band=4e3, coherent_ms=2, threshold=2.4,
                           prn_list=prns, fine_doppler_ms=10),
        track=jcfg.TrackConfig(dll_bw=1.0, el_spacing=0.3),
        n_channels=2 * 2)
    assert (port.PRNS, port.SEED, port.RUN_MS) == (prns, 13, 600)
    _same(port.SIG, to_port(sig))
    _same(port.sky(), [to_port(s) for s in sats])
    _same(port.config(2), to_port(cfg))


# --- the chains at reduced length ----------------------------------------

def _tracks_match(got, ref, sig) -> None:
    """tests/test_torch_driver.py's fused-against-table tolerances."""
    slip = tdriver.replica_slip_samples(
        ref.code_freq - sig.code_freq,
        np.full(ref.code_freq.shape, sig.samples_per_code), sig.code_freq)
    np.testing.assert_allclose(got.abs_sample, ref.abs_sample + slip,
                               rtol=0, atol=5e-4 * sig.fs / sig.code_freq)
    for name in ACCS:
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=2e-3, atol=2.0, err_msg=name)
    np.testing.assert_allclose(got.carr_freq, ref.carr_freq, rtol=0,
                               atol=0.05)


def test_gps_l1_chain_matches_reference_at_600_ms(ex):
    port = ex["torch_e2e_gps_l1"]
    n_ms = 600
    ref_sig, ref_acq = ex["e2e_gps_l1"].SIG, ex["e2e_gps_l1"].ACQ
    x = np.asarray(JIFSimulator(ref_sig, [_gps_l1_sat(ex["e2e_gps_l1"])],
                                noise_sigma=1.0,
                                seed=port.SEED).generate(n_ms + 50))
    head = x[:acq_samples_needed(ref_sig, ref_acq)]
    want = jacquire(head, ref_sig, ref_acq)
    got = acquire(head, port.SIG, port.ACQ, device="cpu")
    assert got.detected_prns() == want.detected_prns() == [7]
    np.testing.assert_array_equal(got.code_phase,
                                  np.asarray(want.code_phase))
    # No fine-Doppler step: the carrier is the grid's bin.
    np.testing.assert_array_equal(got.carr_freq, np.asarray(want.carr_freq))

    ch = jdriver.ChannelInit(prn=7, code_phase=int(want.code_phase[6]),
                             doppler_hz=float(want.carr_freq[6]))
    ref_tr = jdriver.track(JArraySource(x), [ch], ref_sig,
                           ex["e2e_gps_l1"].TRK, n_ms,
                           chunk_ms=port.CHUNK_MS, code_mode="table")
    before = tk.LAUNCHES["track_chunk_fused"]
    got_tr = tdriver.track(ArraySource(x), [to_port(ch)], port.SIG,
                           port.TRK, n_ms, chunk_ms=port.CHUNK_MS,
                           code_mode="fused", device="cpu")
    assert tk.LAUNCHES["track_chunk_fused"] == before
    _tracks_match(got_tr, ref_tr, port.SIG)


def test_position_fix_receiver_matches_reference_at_1_s(ex, monkeypatch):
    port, ref = ex["torch_e2e_position_fix"], ex["e2e_position_fix"]
    n_ms = 1000
    chosen, _ = _position_sky(ref)
    x = np.asarray(JIFSimulator(ref.SIG, _position_sats(ref, chosen),
                                noise_sigma=1.0,
                                seed=port.SEED).generate(n_ms + 50))
    monkeypatch.setattr(jdriver, "resolve_engine",
                        lambda m="auto": "table" if m == "auto" else m)
    want = jrec.run_receiver(JArraySource(x), ref.CFG, n_ms=n_ms)
    got = trec.run_receiver(ArraySource(x), port.CFG, n_ms=n_ms,
                            device="cpu")
    assert got.acq.detected_prns() == want.acq.detected_prns() == sorted(
        chosen)
    for name in ("code_phase", "carr_freq", "detected"):
        np.testing.assert_array_equal(getattr(got.acq, name),
                                      np.asarray(getattr(want.acq, name)))
    assert ([vars(c) for c in got.channels]
            == [vars(c) for c in want.channels])
    _tracks_match(got.track, want.track, port.SIG)


# --- no JAX, and the card by default --------------------------------------

@pytest.fixture(scope="module")
def refused_runs():
    """{example: CompletedProcess} of chip_smoke.EXAMPLE_BOOT asking each
    example for the card, all five processes started together."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would run the example "
                    "(chip_smoke.py phase 39 does that)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", EXAMPLE_BOOT,
         os.path.join(REPO, "examples", name + ".py"), "cuda"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name in EXAMPLES}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=120)
            out[name] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_jax_and_asks_for_the_card(refused_runs, name):
    rc, stdout, stderr = refused_runs[name]
    assert rc != 0, stdout
    assert "refused import" not in stderr, stderr
    # The example imported cleanly; main() raised at resolve_device before
    # doing any work, and printed nothing.
    assert stderr.strip().splitlines()[-1] == (
        "RuntimeError: device cuda requested but "
        "torch.cuda.is_available() is False"), stderr
    assert stdout == "", stdout
