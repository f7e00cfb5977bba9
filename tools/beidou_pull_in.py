"""chip_smoke.py's BeiDou B1I signal, replayed through the reference receiver.

chip_smoke.py's beidou_b1i_live_12ch path makes its signal with the port's
simulator on the card (seed 17). This tool replays that signal through
gnsstpu's ChannelManager, so the port's live result can be held against
the reference's on the same samples. It has two steps, each in a process
of its own:

    python3 tools/beidou_pull_in.py dump SIGNAL.npz [--seconds 28.6]
    python3 tools/beidou_pull_in.py replay SIGNAL.npz

`dump` runs on a CUDA card and imports the port only. It writes the
signal's 2-bit sm2 bytes as chip_smoke.py builds them for a run of
`--seconds`, with the sky PRNs, their Doppler at the start, the absent
PRNs and the receiver position.

`replay` runs anywhere JAX runs and imports the reference only. It runs
gnsstpu's ChannelManager with chip_smoke.py's settings for the path on
those samples: 12 slots, the scan engine ('gather'), the prefetch
pipeline, compact readback, and the online navigator with LSQ fixes. It
prints one JSON line with each PRN's channel starts (epoch, Doppler
against the truth), drops, the decoded PRNs, the fixes and their mean
3D error.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEED = 17                 # chip_smoke.py's beidou_main_path


def dump(path: str, seconds: float) -> None:
    import torch

    import chip_smoke as cs
    from gnsstpu_torch.signals.registry import get_signal

    if not torch.cuda.is_available():
        raise SystemExit("dump needs a CUDA card (the signal is the card's)")
    sats, sky, recv, _ = cs.beidou_constellation(
        cs.BSIG, None, duration_s=seconds, cn0_dbhz=48.0)
    absent = [p for p in range(1, get_signal(cs.BSIG.signal).num_prn + 1)
              if p not in sky][:2]
    n_ms = int(round(seconds * 1000)) + 400      # as k1_family_path
    src = cs.device_signal(cs.BSIG, sats, n_ms, SEED, "cuda", piece_ms=4000)
    np.savez(path, packed=src.packed, n=len(src), seconds=seconds,
             sky=np.array(sorted(sky)), absent=np.array(absent),
             recv=np.asarray(recv, np.float64),
             sat_prn=np.array([s.prn for s in sats]),
             sat_doppler_hz=np.array([s.doppler_hz for s in sats]))
    print(json.dumps({"wrote": path, "bytes": int(src.packed.nbytes),
                      "samples": len(src), "sky": sorted(sky),
                      "absent": absent}))


def replay(path: str) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from gnsstpu.config import (AcqConfig, NavConfig, ReceiverConfig,
                                SignalConfig, TrackConfig)
    from gnsstpu.ops import unpack as up
    from gnsstpu.runtime.manager import ChannelManager
    from gnsstpu.runtime.navigator import OnlineNavigator
    from gnsstpu.runtime.sources import PackedArraySource
    from gnsstpu.runtime.telemetry import Telemetry

    z = np.load(path)
    sig = SignalConfig(signal="beidou_b1i", if_freq=0.0, fs=4.096e6,
                       code_freq=2.046e6, code_length=2046, complex_iq=True)
    trk = TrackConfig(dll_bw=1.5, pll_bw=25.0, fll_bw=150.0,
                      fll_disc="atan", aid_div=1561.098e6 / 2.046e6)
    sky, absent = [int(p) for p in z["sky"]], [int(p) for p in z["absent"]]
    recv = z["recv"]
    pool = sky + absent
    # Unpacked levels are +-1 / +-3; at scale 0.5 the reference's packer
    # gives the same bytes back.
    x = up.unpack_np(z["packed"], "sm2")
    src = PackedArraySource(x, fmt="sm2", scale=0.5)
    del x
    if not np.array_equal(src.packed, z["packed"]):
        raise SystemExit("re-packed samples differ from the card's")
    cfg = ReceiverConfig(
        signal=sig,
        acq=AcqConfig(doppler_band=12e3, coherent_ms=1, threshold=2.0,
                      doppler_step=125.0, prn_list=tuple(pool)),
        track=trk,
        nav=NavConfig(sol_period_ms=500, elevation_mask_deg=10.0,
                      use_tropo=False),
        n_channels=12)
    navr = OnlineNavigator(sig, cfg.nav, retry_ms=500, mode="lsq")
    sink = io.StringIO()
    mgr = ChannelManager(
        src, cfg, telemetry=Telemetry(sink=sink), epoch_ms=100,
        reacq_period_ms=2000, confirm_epochs=12, sync_every=4,
        navigator=navr, prn_pool=pool, prefetch=True, readback="compact",
        engine="gather")
    n_ms = int(round(float(z["seconds"]) * 1000))
    mgr.run(n_ms)
    events = [json.loads(ln) for ln in sink.getvalue().splitlines()]
    truth = dict(zip(z["sat_prn"].tolist(), z["sat_doppler_hz"].tolist()))
    per_prn = {}
    for e in events:
        if e.get("what") == "channel_start":
            per_prn.setdefault(e["prn"], {"starts": [], "drops": []})[
                "starts"].append({"epoch_ms": e["epoch_ms"],
                                  "doppler_hz": e["doppler_hz"],
                                  "off_hz": e["doppler_hz"]
                                  - truth.get(e["prn"], np.nan)})
        elif e.get("what") == "channel_drop":
            per_prn.setdefault(e["prn"], {"starts": [], "drops": []})[
                "drops"].append({"epoch_ms": e["epoch_ms"], "why": e["why"]})
    err = [float(np.linalg.norm([s["x"] - recv[0], s["y"] - recv[1],
                                 s["z"] - recv[2]]))
           for s in navr.solutions]
    out = {"receiver": "gnsstpu ChannelManager, engine gather",
           "seconds": float(z["seconds"]), "sky": sky, "absent": absent,
           "decoded_prns": sorted(int(p) for p in navr.decoded),
           "missing_prns": sorted(set(sky) - set(navr.decoded)),
           "pvt_solutions": len(err),
           "mean_3d_err_m": float(np.mean(err)) if err else None,
           "live_at_end": sorted(int(p) for p in mgr.records[-1].prn if p),
           "prns": {str(p): v for p, v in sorted(per_prn.items())}}
    print(json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("path")
    d.add_argument("--seconds", type=float, default=28.6)
    r = sub.add_parser("replay")
    r.add_argument("path")
    a = ap.parse_args(argv)
    if a.cmd == "dump":
        dump(a.path, a.seconds)
    else:
        replay(a.path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
