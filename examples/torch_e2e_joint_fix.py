"""Joint GPS + GLONASS position fix from 3 + 3 satellites on the PyTorch +
CUDA port.

examples/e2e_joint_fix.py on gnsstpu_torch, with its scenarios, seeds,
constants, printed steps and PASS limits: two 3-SV runs, below each
system's 4-satellite minimum, so NEITHER can fix alone, fused in one LSQ
with an estimated GPS-GLONASS inter-system clock state
(nav.pvt.navigate_joint). Both streams share one nominal sample clock,
as a dual-band front end's channels would. The script imports torch,
numpy and gnsstpu_torch only.

PASS = each subsystem alone produces no solution, the joint solve fixes
with mean 3D error under 30 m and a stable inter-system bias.

The signals are made on the device by the port's simulator with the
reference's noise (IFSimulator(noise="jax")), so they are the very
signals the reference script tracks. Both receivers run kernel K1 at
4,098-sample blocks (the fused engine; its plain twin on the CPU).

Run: python examples/torch_e2e_joint_fix.py [--device cuda|cpu]

The device is the card unless --device says otherwise; without a card
the script raises. main(device) returns a dict of what it checked.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from gnsstpu_torch.config import (AcqConfig, NavConfig,  # noqa: E402
                                  ReceiverConfig, SignalConfig, TrackConfig)
from gnsstpu_torch.device import resolve_device  # noqa: E402
from gnsstpu_torch.nav import geodesy, pvt  # noqa: E402
from gnsstpu_torch.nav import glonass as gl  # noqa: E402
from gnsstpu_torch.nav.orbits import satpos  # noqa: E402
from gnsstpu_torch.nav.types import Ephemeris  # noqa: E402
from gnsstpu_torch.runtime.receiver import run_receiver  # noqa: E402
from gnsstpu_torch.runtime.sources import SimSource  # noqa: E402
from gnsstpu_torch.sim import IFSimulator  # noqa: E402
from gnsstpu_torch.sim.scenario import (  # noqa: E402
    build_scenario, build_scenario_glonass, make_glonass_constellation)

T0 = time.time()
RECV = np.array([3427947.0, 603774.0, 5326967.0])
N_MS = 24000
FS = 4.096e6
NAV = NavConfig(sol_period_ms=500, elevation_mask_deg=10.0, use_tropo=False)
N_EPOCHS = 10


def log(msg):
    print(f"[{time.time() - T0:6.1f}s] {msg}", flush=True)


def gps_setup() -> tuple:
    """(sig, sats, cfg) of the GPS run: the 3 highest SVs of a synthetic
    constellation around t_oe, seed 21 below."""
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
        cand.append(Ephemeris(**d))
    pos, _ = satpos(266400.0, cand)
    _, el, _ = geodesy.topocent(RECV, pos - RECV)
    pick = np.argsort(-el)[:3]
    ephs = {int(k) + 1: cand[k] for k in pick}

    sig = SignalConfig(if_freq=0.0, fs=FS, complex_iq=True)
    sats = build_scenario(sig, ephs, RECV, 44400,
                          duration_s=N_MS / 1000.0, cn0_dbhz=47.0)
    cfg = ReceiverConfig(
        signal=sig,
        acq=AcqConfig(doppler_band=10e3, coherent_ms=2, threshold=2.4,
                      prn_list=tuple(ephs), fine_doppler_ms=10),
        track=TrackConfig(dll_bw=1.0, pll_bw=25.0, fll_bw=250.0),
        nav=NAV, n_channels=3)
    return sig, sats, cfg


def glonass_setup() -> tuple:
    """(sig, sats, cfg) of the GLONASS run: 3 SVs of the synthetic
    constellation broadcasting 8 strings, seed 31 below."""
    sig = SignalConfig(signal="glonass_l1of", if_freq=0.0, fs=FS,
                       code_freq=0.511e6, code_length=511,
                       fdma_step=562.5e3, complex_iq=True)
    tb = 675
    gephs = make_glonass_constellation(RECV, tb, n=3)
    sats, qephs = build_scenario_glonass(
        sig, gephs, RECV, tb * 60 + 30.0, duration_s=N_MS / 1000.0,
        cn0_dbhz=48.0, n_strings=8)
    cfg = ReceiverConfig(
        signal=sig,
        acq=AcqConfig(doppler_band=14e3, coherent_ms=2, threshold=2.5,
                      prn_list=tuple(qephs), fine_doppler_ms=10),
        track=TrackConfig(dll_bw=1.0, pll_bw=25.0, fll_bw=250.0,
                          aid_div=1602e6 / 0.511e6),
        nav=NAV, n_channels=3)
    return sig, sats, cfg


def run_gps(dev):
    sig, sats, cfg = gps_setup()
    sim = IFSimulator(sig, sats, noise_sigma=1.0, seed=21, device=dev,
                      noise="jax")
    out = run_receiver(SimSource(sim, N_MS + 50), cfg, n_ms=N_MS,
                       device=dev)
    log(f"GPS: decoded {sorted(out.ephs)}; single-system nav: "
        f"{'NONE (3 SVs < 4)' if out.nav is None else 'unexpected!'}")
    return sig, out


def run_glonass(dev):
    sig, sats, cfg = glonass_setup()
    sim = IFSimulator(sig, sats, noise_sigma=1.0, seed=31, device=dev,
                      noise="jax")
    out = run_receiver(SimSource(sim, N_MS + 60), cfg, n_ms=N_MS,
                       device=dev)
    log(f"GLONASS: decoded {sorted(out.ephs)}; single-system nav: "
        f"{'NONE (3 SVs < 4)' if out.nav is None else 'unexpected!'}")
    return sig, out


def system_obs(out, sig, satpos_fn):
    """One system's pvt.SystemObs from a ReceiverOutput, every channel
    advanced to the latest anchor time (navigate_from_anchors's
    alignment)."""
    good = [c for c, ch in enumerate(out.channels)
            if ch.prn in out.ephs and out.anchors[c].found]
    period = sig.code_period_s
    t0 = max(out.anchors[c].t_anchor for c in good)
    sf = [out.anchors[c].anchor_idx
          + int(round((t0 - out.anchors[c].t_anchor) / period))
          for c in good]
    return pvt.SystemObs(
        prns=[out.channels[c].prn for c in good],
        abs_sample=out.track.abs_sample[good],
        subframe_start=sf, tow_s=t0, ephs=out.ephs,
        satpos_fn=satpos_fn, code_period_s=period, fs=sig.fs)


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    t0 = time.time()
    log("running 3-SV GPS receiver...")
    sig_g, out_g = run_gps(dev)
    log("running 3-SV GLONASS receiver...")
    sig_r, out_r = run_glonass(dev)
    assert out_g.nav is None and out_r.nav is None

    log("joint solve: 3 GPS + 3 GLONASS pseudoranges, 5 states + "
        "inter-system clock...")
    sol = pvt.navigate_joint(
        [system_obs(out_g, sig_g, satpos),
         system_obs(out_r, sig_r, gl.satpos_gl)], NAV, n_epochs=N_EPOCHS)
    v = sol.valid
    err = np.linalg.norm(np.stack(
        [sol.x[v] - RECV[0], sol.y[v] - RECV[1], sol.z[v] - RECV[2]]),
        axis=0)
    inter = sol.inter_sys[v, 0]
    log(f"joint fix: {int(v.sum())}/10 epochs, mean 3D error "
        f"{err.mean():.1f} m, GPS-GLONASS bias {inter.mean() / 299792458.0 * 1e3:.3f} ms "
        f"(std {np.std(inter):.1f} m)")
    assert v.sum() >= 8 and err.mean() < 30.0 and np.std(inter) < 15.0
    log("PASS: joint GPS+GLONASS fix from subsets neither system could "
        "solve alone")
    return {"signal_s": 2 * N_MS / 1000.0, "wall_s": time.time() - t0,
            "gps_ephemerides": sorted(out_g.ephs),
            "glonass_ephemerides": sorted(out_r.ephs),
            "alone_fixes": [out_g.nav is not None, out_r.nav is not None],
            "valid_epochs": int(v.sum()), "epochs": N_EPOCHS,
            "mean_3d_err_m": float(err.mean()),
            "max_3d_err_m": float(err.max()),
            "inter_sys_bias_std_m": float(np.std(inter)),
            "stage_s": {"gps": dict(out_g.stage_s),
                        "glonass": dict(out_r.stage_s)}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without a "
                    "card)")
    main(ap.parse_args().device)
