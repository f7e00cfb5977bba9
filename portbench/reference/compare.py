"""The comparison that decides `correct`: the program's outputs of every
completed pass, held against the plain reference (truth.py) of the sky
the benchmark made.

Numbers, each with a limit in the configuration file ("limits"):

  missed_sats     satellites in the sky a pass never confirmed (count)
  false_sats      absent PRNs a pass confirmed (count)
  doppler_err_hz  worst |epoch mean of the tracked Doppler - truth| [Hz]
  code_err_m      worst |epoch mean of the code-period start's distance
                  from the true code start| [m]
  symbol_errors   prompts whose sign disagrees with the symbol on the air
                  (count; the navigation symbols, or a pilot's overlay and
                  a data stream's symbols x overlay where the signal has
                  both; one polarity per track)

and, for a sky that carries ephemerides (its `ephs`):

  eph_errors      satellites in the sky without a decoded ephemeris,
                  plus decoded fields that differ from the broadcast ones
                  (the signal module's broadcast(eph), its field table)
  passes_no_fix   completed passes without a fix
  fix_err_m       worst 3-D distance of any fix of a pass from the
                  true receiver position [m]
  fixes_missing   solution epochs without a fix, summed over passes:
                  a fix is due every solution period from the instant the
                  last satellite's ephemeris was on the air in full
                  to the end of the pass, so a pass owes
                  floor((end - that instant) / period) distinct fix epochs

Tracks are judged after `settle_ms` of their own history (loops pulling
in after the handoff), per supervision epoch.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.truth import streams_of

C_LIGHT = 299792458.0


def _lane(h: dict, key: str) -> np.ndarray:
    """One history lane (a list of per-epoch arrays) as one array."""
    return np.concatenate(h[key]) if h.get(key) else np.zeros(0)


def _confirmed(events: list) -> set:
    return {e["prn"] for e in events
            if e.get("type") == "event" and e.get("what") == "channel_confirmed"}


def _sign_errors(prompts: np.ndarray, symbols: np.ndarray) -> int:
    """Prompts whose sign disagrees with the symbol, under the track's
    majority polarity."""
    if len(prompts) == 0:
        return 0
    agree = np.sign(prompts) * symbols
    pol = 1.0 if agree.sum() >= 0 else -1.0
    return int(np.sum(agree * pol <= 0))


def track_numbers(h: dict, streams: dict, sat: int, data_prn,
                  cfg: dict) -> dict:
    """One satellite's track in one pass: worst epoch Doppler and code
    errors and the symbol errors, after the settle time."""
    period_ms = cfg["signal"]["code_period_ms"]
    settle = int(cfg["check"]["settle_ms"] // period_ms)
    per_epoch = int(cfg["manager"]["epoch_ms"] // period_ms)
    evicted = int(h.get("evicted", 0))
    skip = max(0, settle - evicted)
    a = _lane(h, "abs_sample")[skip:]
    n = (len(a) // per_epoch) * per_epoch
    out = {"doppler_err_hz": 0.0, "code_err_m": 0.0, "symbol_errors": 0}
    if n == 0:
        return out
    st = streams[sat]
    a = a[:n]
    dopp = _lane(h, "carr_doppler")[skip:skip + n]
    ep = (n // per_epoch, per_epoch)
    d_err = dopp.astype(np.float64) - st.doppler_hz(a)
    out["doppler_err_hz"] = float(np.max(np.abs(d_err.reshape(ep).mean(1))))
    c_err = st.code_error_chips(a)
    out["code_err_m"] = float(np.max(np.abs(c_err.reshape(ep).mean(1)))
                              * C_LIGHT / st.code_freq)
    sym = st.symbols(a)
    errs = _sign_errors(_lane(h, "i_p")[skip:skip + n], sym)
    if data_prn is not None:
        errs += _sign_errors(_lane(h, "q_p2")[skip:skip + n],
                             streams[data_prn].symbols(a))
    out["symbol_errors"] = errs
    return out


def eph_errors(decoded: dict, sky) -> int:
    """Sky satellites without a decoded ephemeris, plus decoded fields
    that differ from the broadcast values."""
    bad = 0
    for prn, eph in sky.ephs.items():
        if prn not in decoded:
            bad += 1
            continue
        got = decoded[prn][2]
        want = sky.signal.module.broadcast(eph)
        bad += sum(1 for k, v in want.items() if getattr(got, k) != v)
    return bad


def judge(sky, passes: list, cfg: dict) -> dict:
    """{number: value} over every completed pass."""
    streams = streams_of(sky)
    data_off = cfg["signal"].get("data_prn_offset")
    nums = {"missed_sats": 0, "false_sats": 0, "doppler_err_hz": 0.0,
            "code_err_m": 0.0, "symbol_errors": 0}
    nav = bool(sky.ephs)
    if nav:
        nums.update(eph_errors=0, fix_err_m=0.0, passes_no_fix=0,
                    fixes_missing=0)
    done = [p for p in passes if p.complete]
    for p in done:
        conf = _confirmed(p.events)
        nums["missed_sats"] += sum(1 for s in sky.prns if s not in conf)
        nums["false_sats"] += sum(1 for s in sky.absent if s in conf)
        for s in sky.prns:
            if s not in p.history:
                continue
            t = track_numbers(p.history[s], streams, s,
                              None if data_off is None else s + data_off,
                              cfg)
            nums["doppler_err_hz"] = max(nums["doppler_err_hz"],
                                         t["doppler_err_hz"])
            nums["code_err_m"] = max(nums["code_err_m"], t["code_err_m"])
            nums["symbol_errors"] += t["symbol_errors"]
        if nav:
            nums["eph_errors"] += eph_errors(p.decoded, sky)
            if not p.solutions:
                nums["passes_no_fix"] += 1
            for f in p.solutions:
                d = np.array([f["x"], f["y"], f["z"]]) - sky.recv_ecef
                nums["fix_err_m"] = max(nums["fix_err_m"],
                                        float(np.linalg.norm(d)))
            nums["fixes_missing"] += fixes_missing(p, sky, cfg)
    return nums


def fixes_missing(p, sky, cfg: dict) -> int:
    """Fix epochs a pass owes (every solution period from the instant
    the ephemerides were on the air to the pass's end) less the distinct
    epochs it solved."""
    period_s = cfg["nav"]["sol_period_ms"] * 1e-3
    due = int(np.floor((p.signal_ms * 1e-3 - sky.ephemeris_on_air_s)
                       / period_s))
    got = len({round(f["t_ms"], 3) for f in p.solutions})
    return max(0, due - got)


#: How the numbers of several passes combine: counts add up, the worst
#: error stands.
SUMMED = ("missed_sats", "false_sats", "symbol_errors", "eph_errors",
          "passes_no_fix", "fixes_missing")


def merge(per_pass: list) -> dict:
    out = {}
    for nums in per_pass:
        for k, v in nums.items():
            out[k] = (out.get(k, 0) + v if k in SUMMED
                      else max(out.get(k, 0.0), v))
    return out


def verdict(nums: dict, limits: dict, n_passes: int) -> tuple:
    """(correct, [(name, value, limit)]): every number within its limit,
    and at least one completed pass judged."""
    rows = [(k, nums[k], limits[k]) for k in limits if k in nums]
    ok = n_passes >= 1 and all(v <= lim for _, v, lim in rows)
    rows.append(("passes_judged", n_passes, 1))
    missing = [k for k in limits if k not in nums]
    return ok and not missing, rows
