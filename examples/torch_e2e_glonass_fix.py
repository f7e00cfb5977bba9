"""End-to-end GLONASS L1 FDMA position fix on the PyTorch + CUDA port.

examples/e2e_glonass_fix.py on gnsstpu_torch, with its scenario, seed,
constants, printed steps and PASS limit: a synthetic 6-SV FDMA
constellation with geometry-true delays/Dopplers -> per-channel FDMA
acquisition -> tracking -> time-mark + string decode -> time-mark-
anchored pseudoranges -> satposg RK4 PZ-90 orbits -> LSQ. PASS = mean
3D error under 25 m. The script imports torch, numpy and gnsstpu_torch
only.

The signal is made on the device by the port's simulator with the
reference's noise (IFSimulator(noise="jax")), so it is the very signal
the reference script tracks. Tracking runs kernel K1 at 4,098-sample
blocks (the fused engine; its plain twin on the CPU). Each decoded
string ephemeris is printed beside the encoded truth: the decoder reads
string slots past the end of a 4-string message, where a noise string
that passes the KX check can overwrite a field (the reference decoder
does the same); a field that differs is reported, not failed.

Run: python examples/torch_e2e_glonass_fix.py [--device cuda|cpu]

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
from gnsstpu_torch.runtime.receiver import run_receiver  # noqa: E402
from gnsstpu_torch.runtime.sources import SimSource  # noqa: E402
from gnsstpu_torch.sim import IFSimulator  # noqa: E402
from gnsstpu_torch.sim.scenario import (  # noqa: E402
    build_scenario_glonass, make_glonass_constellation)

T0 = time.time()
RECV = np.array([3427947.0, 603774.0, 5326967.0])   # ECEF [m]
TB = 675                                            # 11:15 Moscow day
T_START = TB * 60 + 30.0
N_MS = 10000
SEED = 31

SIG = SignalConfig(signal="glonass_l1of", if_freq=0.0, fs=4.096e6,
                   code_freq=0.511e6, code_length=511,
                   fdma_step=562.5e3, complex_iq=True)
CFG = ReceiverConfig(
    signal=SIG,
    acq=AcqConfig(doppler_band=14e3, coherent_ms=2, threshold=2.5),
    track=TrackConfig(dll_bw=1.0, pll_bw=25.0, fll_bw=250.0,
                      aid_div=1602e6 / 0.511e6),
    nav=NavConfig(sol_period_ms=500, elevation_mask_deg=10.0,
                  use_tropo=False),
    n_channels=6, ms_to_process=N_MS)
#: The string-ephemeris fields tests/test_glonass.py:285-287 holds
#: bit-exact against the encoded truth.
EPH_FIELDS = ("x", "y", "z", "xdot", "ydot", "zdot", "taun", "gamman",
              "tb", "n")


def log(msg):
    print(f"[{time.time() - T0:6.1f}s] {msg}", flush=True)


def scenario() -> tuple:
    """(SatParams of the 6 SVs, {prn: the quantised ephemeris each
    broadcasts in 4 strings})."""
    gephs = make_glonass_constellation(RECV, TB, n=6)
    return build_scenario_glonass(SIG, gephs, RECV, T_START,
                                  duration_s=N_MS / 1000.0,
                                  cn0_dbhz=48.0, n_strings=4)


def eph_mismatches(decoded: dict, truth: dict) -> dict:
    """{prn: [EPH_FIELDS that differ from the truth]} of the decoded
    string ephemerides."""
    return {prn: [f for f in EPH_FIELDS
                  if getattr(dec, f) != getattr(truth[prn], f)]
            for prn, dec in sorted(decoded.items()) if prn in truth}


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    t0 = time.time()
    sats, qephs = scenario()
    log(f"scenario: {len(sats)} GLONASS SVs, freq channels "
        f"{sorted(p - 7 for p in qephs)}")
    sim = IFSimulator(SIG, sats, noise_sigma=1.0, seed=SEED, device=dev,
                      noise="jax")
    src = SimSource(sim, N_MS + 60)

    out = run_receiver(src, CFG, n_ms=N_MS, device=dev)
    log(f"acquired freq channels for PRNs {sorted(c.prn for c in out.channels)}")
    log(f"string ephemerides decoded: {sorted(out.ephs)}")
    bad = eph_mismatches(out.ephs, qephs)
    for prn, fields in bad.items():
        dec = out.ephs[prn]
        log(f"  PRN {prn}: x {dec.x:.6f} y {dec.y:.6f} z {dec.z:.6f} km, "
            f"tb {dec.tb}, n {dec.n} | "
            + ("equal to the encoded truth" if not fields else
               "differs from the encoded truth in "
               + ", ".join(f"{f} ({getattr(dec, f)} vs "
                           f"{getattr(qephs[prn], f)})" for f in fields)))

    assert out.nav is not None, "no navigation solution"
    v = out.nav.valid
    err = np.linalg.norm(np.stack([
        out.nav.x[v] - RECV[0], out.nav.y[v] - RECV[1],
        out.nav.z[v] - RECV[2]]), axis=0)
    log(f"{v.sum()} valid epochs, mean 3D error {err.mean():.1f} m, "
        f"max {err.max():.1f} m")
    assert err.mean() < 25.0, "FAIL: mean 3D error too large"
    log("PASS: GLONASS FDMA position fix recovered")
    return {"signal_s": N_MS / 1000.0, "wall_s": time.time() - t0,
            "acquired": sorted(c.prn for c in out.channels),
            "ephemerides": sorted(out.ephs),
            "eph_mismatches": {str(p): f for p, f in bad.items() if f},
            "valid_epochs": int(v.sum()),
            "mean_3d_err_m": float(err.mean()),
            "max_3d_err_m": float(err.max()),
            "stage_s": dict(out.stage_s)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without a "
                    "card)")
    main(ap.parse_args().device)
