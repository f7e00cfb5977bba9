"""chip_smoke.py's offline fixes (phases 22-25) by tracking engine and by
signal, and the reference receiver on the same configurations.

    python3 tools/offline_engines.py card        # a CUDA card, the port only
    python3 tools/offline_engines.py reference   # anywhere JAX runs

`card` runs each offline configuration (chip_smoke.py's solve_setup: GPS
L1 C/A, Galileo E1B, BeiDou B1I, GLONASS L1OF, each as its reference test
sets it) on two signals of the port's simulator: the reference test's own
(IFSimulator(noise="jax") behind the reference's SimSource, as phases
22-25 run) and one with the port's torch noise from the same seed. Each
goes through the port's chain three ways: the fused kernel as the
drivers run it (its abs_sample less the replica's half slip,
tracking.driver.replica_slip_samples), the same tracks with that term
put back, and the exact scan engine ('gather'). It prints one JSON line
per configuration and signal: the mean and max 3D error and the valid
epochs of each.

`reference` runs gnsstpu's run_receiver (its 'auto' engine, the exact
scan off a TPU) on the CPU on each reference test's own signal and
prints the same errors.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _errors(nav, recv) -> list:
    """[mean 3D error m, max m, valid epochs] of a NavSolutions."""
    if nav is None or not np.any(nav.valid):
        return [None, None, 0]
    v = nav.valid
    e = np.linalg.norm(np.stack([nav.x, nav.y, nav.z], 1)[v] - recv, axis=1)
    return [float(e.mean()), float(e.max()), int(v.sum())]


def _chain(src, st: dict, mode: str, device):
    """The port's chain (run_receiver's steps) with a chosen engine:
    (track record, channels, navigate(abs_sample) -> errors)."""
    from gnsstpu_torch.acquisition.search import (acq_samples_needed,
                                                  acquire, acquire_fdma)
    from gnsstpu_torch.runtime import receiver as rx
    from gnsstpu_torch.signals.registry import get_signal
    from gnsstpu_torch.tracking.boc import track_boc
    from gnsstpu_torch.tracking.driver import track

    sig, cfg, n_ms = st["sig"], st["cfg"], st["n_ms"]
    sd = get_signal(sig.signal)
    x = src.read(0, acq_samples_needed(sig, cfg.acq))
    x = x.cpu().numpy() if hasattr(x, "cpu") else x
    search = acquire_fdma if sd.fdma_zero_prn is not None else acquire
    chans = rx.allocate_channels(search(x, sig, cfg.acq, device=device),
                                 cfg.n_channels, sd=sd, if_freq=sig.if_freq)
    if sig.signal == "galileo_e1b":
        tr = track_boc(src, chans, sig, cfg.track, n_ms, code_mode=mode,
                       device=device)
    else:
        tr = track(src, chans, sig, cfg.track, n_ms, code_mode=mode,
                   device=device)

    def fix(abs_sample):
        tr2 = dataclasses.replace(tr, abs_sample=abs_sample)
        _, anchors, ephs, _, fns = rx.decode_nav(tr2, chans, sig)
        nav = rx.navigate_from_anchors(tr2, chans, anchors, ephs, sig,
                                       cfg.nav, n_ms, fns)
        return _errors(nav, st["recv"])

    return tr, fix


def card() -> None:
    import torch

    import chip_smoke as cs
    from gnsstpu_torch.runtime.sources import SimSource
    from gnsstpu_torch.sim import IFSimulator
    from gnsstpu_torch.tracking.driver import replica_slip_samples

    if not torch.cuda.is_available():
        raise SystemExit("card needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(cs.smi_line(), flush=True)
    for name in cs.SOLVE_PHASES:
        st = cs.solve_setup(name)
        sig = st["sig"]
        # The code whose phase the record carries (E1B: the primary code).
        code_freq = sig.code_freq / (2.0 if sig.signal == "galileo_e1b"
                                     else 1.0)
        for noise in ("jax", "torch"):
            sim = IFSimulator(sig, st["sats"], noise_sigma=1.0,
                              seed=st["seed"], device=dev, noise=noise)
            row = {"config": name, "signal": ("reference test's" if noise ==
                                              "jax" else "torch noise")}
            tr, fix = _chain(SimSource(sim, st["src_ms"]), st, "fused", dev)
            row["fused"] = fix(tr.abs_sample)
            slip = replica_slip_samples(
                tr.code_freq - code_freq,
                np.full(tr.code_freq.shape, sig.samples_per_code), code_freq)
            row["fused_without_half_slip"] = fix(tr.abs_sample - slip)
            tr, fix = _chain(SimSource(sim, st["src_ms"]), st, "gather",
                             dev)
            row["exact_gather"] = fix(tr.abs_sample)
            print(json.dumps(row), flush=True)


def reference() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_beidou
    import test_full_chain
    import test_galileo
    from gnsstpu.config import (AcqConfig, NavConfig, ReceiverConfig,
                                SignalConfig, TrackConfig)
    from gnsstpu.runtime.receiver import run_receiver
    from gnsstpu.runtime.sources import SimSource
    from gnsstpu.sim import IFSimulator
    from gnsstpu.sim.scenario import (build_scenario, build_scenario_beidou,
                                      build_scenario_galileo,
                                      build_scenario_glonass,
                                      make_glonass_constellation)

    nav = NavConfig(sol_period_ms=500, elevation_mask_deg=10.0,
                    use_tropo=False)
    fc = test_full_chain
    sats = build_scenario(fc.SIG, fc.visible_ephs(6), fc.RECV_ECEF,
                          fc.TOW0_6S, duration_s=fc.N_MS / 1000.0,
                          cn0_dbhz=47.0)
    runs = [("gps_l1_solve_8ch", fc.SIG, sats, fc.CFG, fc.N_MS,
             fc.N_MS + 50, 21, fc.RECV_ECEF)]
    g = test_galileo
    sats, _ = build_scenario_galileo(
        g.SIG, g.make_gal_constellation(5), g.GAL_RECV, g.GAL_TOW0,
        duration_s=g.GAL_NPER * g.SIG.code_period_s, cn0_dbhz=48.0,
        n_pages=6)
    cfg = ReceiverConfig(
        signal=g.SIG,
        acq=AcqConfig(doppler_band=9e3, coherent_ms=1, threshold=2.2,
                      doppler_step=75.0,
                      prn_list=tuple(sorted(s.prn for s in sats))),
        track=TrackConfig(dll_bw=1.0, el_spacing=0.25, pll_bw=15.0,
                          fll_bw=50.0, sll_bw=0.5, sll_spacing=0.25,
                          aid_div=1540.0),
        nav=nav, n_channels=5, ms_to_process=g.GAL_NPER)
    runs.append(("galileo_e1b_solve_5ch", g.SIG, sats, cfg, g.GAL_NPER,
                 int((g.GAL_NPER + 8) * g.SIG.code_period_ms), 23,
                 g.GAL_RECV))
    b = test_beidou
    bsig = SignalConfig(signal="beidou_b1i", if_freq=0.0, fs=4.096e6,
                        code_freq=2.046e6, code_length=2046,
                        complex_iq=True)
    sats, _ = build_scenario_beidou(
        bsig, b.make_bd_constellation(5), b.BD_RECV, b.BD_SOW0,
        duration_s=b.BD_NMS / 1000.0, cn0_dbhz=48.0, n_subframes=4)
    cfg = ReceiverConfig(
        signal=bsig,
        acq=AcqConfig(doppler_band=12e3, coherent_ms=1, threshold=2.0,
                      doppler_step=125.0),
        track=TrackConfig(dll_bw=1.5, pll_bw=25.0, fll_bw=150.0,
                          fll_disc="atan", aid_div=1561.098e6 / 2.046e6),
        nav=nav, n_channels=6, ms_to_process=b.BD_NMS)
    runs.append(("beidou_b1i_solve_6ch", bsig, sats, cfg, b.BD_NMS,
                 b.BD_NMS + 60, 17, b.BD_RECV))
    recv = np.array([3427947.0, 603774.0, 5326967.0])
    osig = SignalConfig(signal="glonass_l1of", if_freq=0.0, fs=4.096e6,
                        code_freq=0.511e6, code_length=511,
                        fdma_step=562.5e3, complex_iq=True)
    sats, _ = build_scenario_glonass(
        osig, make_glonass_constellation(recv, 675, n=6), recv,
        675 * 60 + 30.0, duration_s=10.0, cn0_dbhz=48.0, n_strings=4)
    cfg = ReceiverConfig(
        signal=osig, acq=AcqConfig(doppler_band=14e3, coherent_ms=2,
                                   threshold=2.5),
        track=TrackConfig(dll_bw=1.0, pll_bw=25.0, fll_bw=250.0,
                          aid_div=1602e6 / 0.511e6),
        nav=nav, n_channels=6, ms_to_process=10000)
    runs.append(("glonass_l1of_solve_6ch", osig, sats, cfg, 10000, 10060,
                 31, recv))
    for name, sig, sats, cfg, n_ms, src_ms, seed, recv in runs:
        sim = IFSimulator(sig, sats, noise_sigma=1.0, seed=seed)
        out = run_receiver(SimSource(sim, src_ms), cfg, n_ms=n_ms)
        print(json.dumps({"config": name, "signal": "reference test's",
                          "gnsstpu_cpu": _errors(out.nav, recv)}),
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=["card", "reference"])
    args = ap.parse_args()
    card() if args.what == "card" else reference()


if __name__ == "__main__":
    main()
