"""The control of the comparison: the plain reference put in the program's
place, computed one step below the precision the configuration states
(its device lanes, float32 on the card, in bfloat16; its host quantities,
float64, in float32), must come out as not correct.

    python3 portbench/control.py --workload <cell> --seeds 11,22,33

prints, per seed, the numbers of the comparison for the control's pass
and for the same pass made at the stated precision (which must pass),
each beside its limit, then one JSON line. It needs no card: the control
is the reference's arithmetic, not the program's.
"""

from __future__ import annotations

import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import plan  # noqa: E402
from portbench.gen import sky as skymod  # noqa: E402
from portbench.reference import compare  # noqa: E402
from portbench.reference.truth import streams_of  # noqa: E402

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}
#: The precision one step below each stated one.
BELOW = {"float64": "float32", "float32": "bfloat16"}


def _round(x, dtype: str) -> np.ndarray:
    """x (float64) rounded to dtype and back."""
    return torch.as_tensor(np.asarray(x, np.float64)).to(
        DTYPES[dtype]).to(torch.float64).numpy()


def ideal_pass(sky, cfg: dict, n_ms: int, device_dtype: str,
               host_dtype: str):
    """The reference in the program's place: one complete pass whose
    tracks are the truth (code-period ends, Dopplers and symbols of every
    satellite in the sky, as the program's history holds them), whose
    ephemerides are the broadcast values and whose fixes, one every
    solution period once the ephemerides are on the air, are the true
    position, with the device lanes in device_dtype and the host
    quantities in host_dtype."""
    streams = streams_of(sky)
    data_off = cfg["signal"].get("data_prn_offset")
    spc = sky.signal.samples_per_code
    n_per = int(n_ms // cfg["signal"]["code_period_ms"]) - 2
    history, events = {}, []
    for prn in sky.prns:
        st = streams[prn]
        ends = st.code_starts(2.0 * spc, n_per)
        h = {"abs_sample": [_round(ends, host_dtype)],
             "carr_doppler": [_round(st.doppler_hz(ends), device_dtype)],
             "i_p": [_round(1e3 * st.symbols(ends), device_dtype)],
             "start_ms": 0, "evicted": 0}
        if data_off is not None:
            h["q_p2"] = [_round(1e3 * streams[prn + data_off].symbols(ends),
                                device_dtype)]
        history[prn] = h
        events.append({"type": "event", "what": "channel_confirmed",
                       "prn": prn})
    decoded = {}
    for prn, eph in sky.ephs.items():
        want = sky.signal.module.broadcast(eph)
        fields = {k: (float(_round(v, host_dtype)) if isinstance(v, float)
                      else v) for k, v in want.items()}
        decoded[prn] = (0, 0.0, types.SimpleNamespace(**fields))
    solutions = []
    if sky.recv_ecef is not None:
        x, y, z = _round(sky.recv_ecef, host_dtype)
        period_ms = cfg["nav"]["sol_period_ms"]
        first = int(np.ceil(sky.ephemeris_on_air_s * 1e3 / period_ms))
        solutions = [{"t_ms": float(k * period_ms), "x": x, "y": y, "z": z}
                     for k in range(first, n_ms // period_ms + 1)]
    return types.SimpleNamespace(complete=True, events=events,
                                 history=history, decoded=decoded,
                                 solutions=solutions, signal_ms=n_ms)


def readings(cfg: dict, traffic: dict, seed: int) -> dict:
    """{'stated': (correct, rows), 'control': (correct, rows)} for one
    seed: the reference's pass at the configuration's precision and one
    step below it."""
    sky = skymod.make_sky(cfg, traffic, seed)
    n_ms = traffic["recording_ms"]
    prec = cfg["precision"]
    out = {}
    for tag, dev, host in (
            ("stated", prec["device"], prec["host"]),
            ("control", BELOW[prec["device"]], BELOW[prec["host"]])):
        nums = compare.judge(sky, [ideal_pass(sky, cfg, n_ms, dev, host)],
                             cfg)
        out[tag] = compare.verdict(nums, cfg["limits"], 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    args = ap.parse_args(argv)
    cell = plan.plan(plan.load_bench(), args.workload)
    res = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(cell.config, cell.traffic, seed)
        res[seed] = {tag: {"correct": ok,
                           "numbers": {k: v for k, v, _ in rows}}
                     for tag, (ok, rows) in r.items()}
        for tag, (ok, rows) in r.items():
            print(f"seed {seed} {tag} correct={ok} "
                  + " ".join(f"{k}={v} (limit {lim})" for k, v, lim in rows))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
