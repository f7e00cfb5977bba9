"""End-to-end PVT demo on the PyTorch + CUDA port: 6-satellite scenario ->
full receiver -> 3D fix.

examples/e2e_position_fix.py on gnsstpu_torch, with its scenario, seed,
constants, printed steps and PASS limit: a geometry-consistent
multi-SV GPS L1 IF stream (delays, Doppler and nav data all derived from
broadcast ephemerides + a receiver position) through the complete
receiver pipeline (runtime.receiver.run_receiver: acquisition on the
device, the chunked tracker, decode and navigation on the host), and the
position error. The script imports torch, numpy and gnsstpu_torch only.

The signal is made on the device by the port's simulator with the
reference's noise (IFSimulator(noise="jax")), so it is the very signal
the reference script tracks. Tracking runs kernel K1 (the fused engine;
its plain twin on the CPU), one launch per 256 ms chunk. The port's
offline pseudoranges have the fused engine's half replica slip taken off
(tracking/driver.py::replica_slip_samples); the reference's do not.

Run: python examples/torch_e2e_position_fix.py [--device cuda|cpu]

The device is the card unless --device says otherwise; without a card
the script raises. main(device) returns a dict of what it checked.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from gnsstpu_torch.config import (AcqConfig, NavConfig,  # noqa: E402
                                  ReceiverConfig, SignalConfig, TrackConfig)
from gnsstpu_torch.device import resolve_device  # noqa: E402
from gnsstpu_torch.nav import geodesy  # noqa: E402
from gnsstpu_torch.nav.orbits import satpos  # noqa: E402
from gnsstpu_torch.nav.types import Ephemeris  # noqa: E402
from gnsstpu_torch.runtime.receiver import run_receiver  # noqa: E402
from gnsstpu_torch.runtime.sources import SimSource  # noqa: E402
from gnsstpu_torch.sim import IFSimulator  # noqa: E402
from gnsstpu_torch.sim.scenario import build_scenario  # noqa: E402

BASE_EPH = dict(
    t_oc=266400.0, a_f0=2.45e-4, a_f1=-3.2e-12, a_f2=0.0, T_GD=-4.656e-9,
    sqrtA=5153.712, e=0.0123456, M_0=1.23456, deltan=4.2e-9,
    omega=-1.87654, omega_0=-2.0312, omegaDot=-8.1e-9,
    i_0=0.96123, iDot=4.0e-10, t_oe=266400.0,
    C_uc=-6.7e-7, C_us=8.1e-6, C_rc=221.5625, C_rs=-12.8125,
    C_ic=-7.45e-8, C_is=1.12e-7, valid=True,
)
RECV_ECEF = np.array([3427947.0, 603774.0, 5326967.0])
TOW0_6S = 44400
N_MS = 24000
SEED = 21

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
CFG = ReceiverConfig(
    signal=SIG,
    acq=AcqConfig(doppler_band=12e3, coherent_ms=2, threshold=2.5),
    track=TrackConfig(dll_bw=1.0, pll_bw=25.0, fll_bw=250.0),
    nav=NavConfig(sol_period_ms=500, elevation_mask_deg=10.0,
                  use_tropo=False),
    n_channels=8, ms_to_process=N_MS,
)


def choose_sky() -> tuple:
    """({prn: Ephemeris} of the 6 highest of 24 synthetic SVs at the first
    subframe's time, every SV's elevation [deg])."""
    ephs = []
    for k in range(24):
        d = dict(BASE_EPH)
        d["M_0"] = (BASE_EPH["M_0"] + 2.1 * k) % (2 * np.pi) - np.pi
        d["omega_0"] = (BASE_EPH["omega_0"] + 1.1 * k) % (2 * np.pi) - np.pi
        d["i_0"] = 0.93 + 0.03 * (k % 3)
        ephs.append(Ephemeris(**d))
    pos, _ = satpos(TOW0_6S * 6.0, ephs)
    _, el, _ = geodesy.topocent(RECV_ECEF, pos - RECV_ECEF)
    return {int(k) + 1: ephs[k] for k in np.argsort(-el)[:6]}, el


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    t0 = time.time()
    chosen, el = choose_sky()
    print(f"[{time.time()-t0:6.1f}s] scenario: PRNs {sorted(chosen)}, "
          f"elevations {np.round(np.sort(el)[::-1][:6], 1)} deg")

    sats = build_scenario(SIG, chosen, RECV_ECEF, TOW0_6S,
                          duration_s=N_MS / 1000.0, cn0_dbhz=47.0)
    sim = IFSimulator(SIG, sats, noise_sigma=1.0, seed=SEED, device=dev,
                      noise="jax")
    src = SimSource(sim, N_MS + 50)

    out = run_receiver(src, CFG, n_ms=N_MS, device=dev)
    print(f"[{time.time()-t0:6.1f}s] receiver done: acquired "
          f"{[c.prn for c in out.channels]}, ephemerides for "
          f"{sorted(out.ephs)}")
    assert out.nav is not None
    v = out.nav.valid
    err3d = np.linalg.norm(np.stack([
        out.nav.x[v] - RECV_ECEF[0], out.nav.y[v] - RECV_ECEF[1],
        out.nav.z[v] - RECV_ECEF[2]]), axis=0)
    lat, lon, h = (np.mean(out.nav.latitude[v]), np.mean(out.nav.longitude[v]),
                   np.mean(out.nav.height[v]))
    print(f"[{time.time()-t0:6.1f}s] {v.sum()} epochs: "
          f"lat {lat:.6f} lon {lon:.6f} h {h:.1f} m | "
          f"3D err mean {np.mean(err3d):.1f} m max {np.max(err3d):.1f} m | "
          f"GDOP {np.mean(out.nav.dop[v, 0]):.1f}")
    assert np.mean(err3d) < 20.0
    wall = time.time() - t0
    print(f"[{wall:6.1f}s] PASS: position fix within 20 m of truth")
    return {"signal_s": N_MS / 1000.0, "wall_s": wall,
            "acquired": [c.prn for c in out.channels],
            "ephemerides": sorted(out.ephs), "valid_epochs": int(v.sum()),
            "mean_3d_err_m": float(np.mean(err3d)),
            "max_3d_err_m": float(np.max(err3d)),
            "mean_gdop": float(np.mean(out.nav.dop[v, 0])),
            "stage_s": dict(out.stage_s)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without a "
                    "card)")
    main(ap.parse_args().device)
