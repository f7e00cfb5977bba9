"""The port's benchmark on the card (port of the repository's bench.py).

    python -m gnsstpu_torch bench [--device cuda|cpu]

Headline: 12-channel GPS L1 C/A tracking realtime factor, kernel K1
(csrc/track_fused.cu, the same launch the live ChannelManager makes) on
2.048 Msps complex IF. The reference receiver's bar is 12 channels at 1x
real time (BASELINE.md).

Also measured, as bench.py measures them:
  * K1's channel scaling, 12 / 48 / 192 / 768 channels, with K1's time
    per launch alone and its residency (CTAs per SM, waves over the SMs);
  * the full 32-PRN x 14 kHz (29-bin) x 2,048-lag cold search
    (ops/fft_acquire.acquire_cube on torch.fft, cuFFT on the card), in
    search cells/s and searches/s;
  * the live ChannelManager end to end with the online navigator in the
    measured loop (host feed, upload, supervision, LNAV decode, LSQ PVT),
    host-fed and with the packed signal resident on the card, each with
    its per-stage task_health breakdown.

Timing method: the slope between a chain of k_lo and a chain of k_hi
dependent calls, the best of `reps` each after a warm-up chain. On the
card a spin kernel is queued ahead of each chain, so the host has
enqueued the whole chain before the card starts it, and CUDA events
around the chain time the card's work without the host's dispatch and
without a readback inside the chain; on the CPU, time.perf_counter.
The manager numbers are wall-clock end to end on the card's host.

main() prints ONE JSON line with bench.py's keys:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "extra": {...}}
"""

from __future__ import annotations

import json
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from gnsstpu_torch.config import (AcqConfig, NavConfig, ReceiverConfig,
                                  SignalConfig, TrackConfig)
from gnsstpu_torch.device import resolve_device, u32_tensor
from gnsstpu_torch.ops import fft_acquire
from gnsstpu_torch.ops import track_kernel as tk
from gnsstpu_torch.runtime.manager import ChannelManager
from gnsstpu_torch.runtime.navigator import OnlineNavigator
from gnsstpu_torch.runtime.sources import (DevicePackedArraySource,
                                           PackedArraySource)
from gnsstpu_torch.runtime.telemetry import Telemetry
from gnsstpu_torch.sim import IFSimulator, SatParams
from gnsstpu_torch.sim.scenario import bench_constellation, position_error_m
from gnsstpu_torch.tracking import scan as tscan
from gnsstpu_torch.tracking.fused import (fused_code_table, fused_tap_rows,
                                          kernel_inputs, kernel_kwargs,
                                          make_fused_tracker)

#: The GPS main path's front end and loops (bench.py::main and
#: bench_manager): 2.048 Msps complex at IF 0.
GPS_SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
GPS_TRK = TrackConfig(dll_bw=1.0, el_spacing=0.3, pll_bw=25.0, fll_bw=250.0)
#: The live receiver's run (bench.py::bench_manager): seconds of signal,
#: channels, 500 ms epochs x 8 per superepoch, a search every 1 s, and the
#: navigator's 36 s history window.
GPS_SECONDS, GPS_CHANNELS, GPS_EPOCH_MS, GPS_SYNC = 44, 12, 500, 8
GPS_REACQ_MS, GPS_HISTORY_MS = 1000, 36_000


def gps_sky(sig: SignalConfig = GPS_SIG, n_channels: int = GPS_CHANNELS,
            seconds: int = GPS_SECONDS) -> tuple:
    """(sats, sky PRNs, receiver ECEF, absent PRNs) of the live GPS run:
    bench_constellation's n_channels - 1 highest SVs (one slot stays idle)
    plus 2 PRNs not in the sky, so a due reacquisition period runs a real
    cold search."""
    sats, prns, recv = bench_constellation(sig, n_channels - 1,
                                           duration_s=seconds + 1.0)
    absent = [p for p in range(1, 33) if p not in prns][:2]
    return sats, prns, recv, absent


def gps_config(pool, sig: SignalConfig = GPS_SIG,
               n_channels: int = GPS_CHANNELS) -> ReceiverConfig:
    return ReceiverConfig(
        signal=sig,
        acq=AcqConfig(doppler_band=8e3, coherent_ms=2, threshold=2.4,
                      prn_list=tuple(pool)),
        track=GPS_TRK,
        nav=NavConfig(sol_period_ms=1000, elevation_mask_deg=5.0,
                      use_tropo=False),
        n_channels=n_channels)


def gps_manager(src, cfg: ReceiverConfig, pool, *, device, telemetry,
                navigator, epoch_ms: int = GPS_EPOCH_MS,
                sync_every: int = GPS_SYNC,
                reacq_period_ms: int = GPS_REACQ_MS, prefetch: bool = True,
                readback: str = "compact", engine: str = "auto",
                **kw) -> ChannelManager:
    """The live GPS run's ChannelManager over `src` (`kw`: the manager's
    other options, e.g. mesh or commands)."""
    return ChannelManager(
        src, cfg, device=device, telemetry=telemetry, epoch_ms=epoch_ms,
        reacq_period_ms=reacq_period_ms, sync_every=sync_every,
        navigator=navigator, prn_pool=pool, prefetch=prefetch,
        readback=readback, history_window_ms=GPS_HISTORY_MS, engine=engine,
        **kw)


def gps_windows(n_ms: int, epoch_ms: int = GPS_EPOCH_MS,
                sync_every: int = GPS_SYNC) -> tuple:
    """(warm-up ms, measured ms) of an n_ms run: two superepochs of
    warm-up, then an even number of whole superepochs that end at least
    one epoch before the signal does."""
    sup_ms = sync_every * epoch_ms
    warm_ms = 2 * sup_ms
    meas_ms = ((n_ms - warm_ms - epoch_ms) // (2 * sup_ms)) * 2 * sup_ms
    return warm_ms, meas_ms


def _timed_s(fn, device: torch.device, spin_cycles: int = 50_000_000,
             tries: int = 4) -> float:
    """Seconds fn() takes: on the card its work between two CUDA events,
    queued behind a spin kernel so the host enqueues all of fn's work
    before the card starts it; on the CPU, perf_counter. If the card
    reached the first event before fn() was queued (the spin was too
    short for the host's dispatch), fn() runs again behind a spin 4x as
    long; after `tries` such runs it raises."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    for _ in range(tries):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)      # 50M cycles: ~25-35 ms
        e0.record()
        fn()
        queued_behind_spin = not e0.query()
        e1.record()
        e1.synchronize()
        if queued_behind_spin:
            return e0.elapsed_time(e1) * 1e-3
        spin_cycles *= 4
    raise RuntimeError(f"the host's dispatch of fn outlasted a spin of "
                       f"{spin_cycles // 4} cycles: its time would "
                       f"include the dispatch")


def _slope_time(run_k, k_lo: int, k_hi: int, reps: int = 4, *,
                device: torch.device) -> float:
    """Seconds per call: the slope between a chain of k_lo and one of
    k_hi dependent calls (run_k(K) runs K of them), the best of `reps`
    timings of each after a warm-up chain."""
    res = {}
    for K in (k_lo, k_hi):
        run_k(K)                              # warm-up (and first build)
        res[K] = min(_timed_s(lambda: run_k(K), device)
                     for _ in range(reps))
    return max((res[k_hi] - res[k_lo]) / (k_hi - k_lo), 1e-9)


def tracking_sky(C: int) -> list:
    """bench.py::bench_tracking's C channels: PRN (i % 32) + 1, Doppler
    300 ((i % 12) - 6) Hz, code phase 77 i mod 1000 chips, 47 dB-Hz."""
    return [SatParams(prn=(i % 32) + 1, doppler_hz=300.0 * ((i % 12) - 6),
                      code_phase_chips=(77.0 * i) % 1000, cn0_dbhz=47.0)
            for i in range(C)]


class TrackingSetup(NamedTuple):
    """bench_tracking's inputs on one device and its K1 tracker."""

    chunk: torch.Tensor        # f32 [(n_blocks + 3) ms of samples, 2]
    tab: torch.Tensor          # int8 [C, R, plane_stride(blkp)]
    consts: tuple              # (carrier NCO base steps, 1 / aid_div)
    state0: tscan.TrackState
    tracker: object            # make_fused_tracker's track_chunk
    kw: dict                   # K1's static arguments (kernel_kwargs)


def tracking_setup(sig: SignalConfig, trk: TrackConfig, C: int,
                   n_blocks: int, device, samples=None) -> TrackingSetup:
    """bench.py::bench_tracking's inputs: only the first satellite is in
    the signal (seed 2, n_blocks + 3 ms; `samples` [N, 2] replaces it),
    every channel starts 30 Hz off its Doppler, and the tap rows of the
    first min(C, 32) PRNs go to the card once and are indexed there into
    one row per channel."""
    dev = resolve_device(device)
    sats = tracking_sky(C)
    if samples is None:
        chunk = IFSimulator(sig, sats[:1], noise_sigma=1.0, seed=2,
                            device=dev).generate_tensor(n_blocks + 3)
    else:
        chunk = torch.as_tensor(np.array(samples, np.float32), device=dev)
    n_base = min(C, 32)
    rows = torch.as_tensor(fused_tap_rows(fused_code_table(
        sig, trk, list(range(1, n_base + 1)))), device=dev)
    tab = rows[torch.arange(C, device=dev) % n_base]
    cb, ia = tscan.channel_consts(sig, trk, [s.prn for s in sats])
    spchip = sig.fs / sig.code_freq
    state0 = tscan.TrackState.init(
        np.array([int(round(s.code_phase_chips * spchip)) for s in sats]),
        np.array([s.doppler_hz + 30.0 for s in sats], np.float32),
        device=dev)
    return TrackingSetup(chunk, tab, (u32_tensor(cb, dev),
                                      torch.as_tensor(ia, device=dev)),
                         state0,
                         make_fused_tracker(sig, trk, n_blocks=n_blocks),
                         kernel_kwargs(sig, trk, n_blocks=n_blocks))


def rebase(s: tscan.TrackState) -> tscan.TrackState:
    """bench.py's rebase: every channel's cursor moved back by the
    slowest one's and capped at 2, on the device (no host readback), so
    a chain of calls keeps reading the same chunk."""
    sp = s.corr.sample_pos
    return s._replace(corr=s.corr._replace(
        sample_pos=torch.clamp(sp - sp.min(), max=2)))


def tracking_chain(st: TrackingSetup, state: tscan.TrackState,
                   K: int) -> tuple:
    """K dependent tracker calls, each after a rebase: (state, the last
    call's outputs)."""
    last = None
    for _ in range(K):
        state, last = st.tracker(st.chunk, st.tab, st.consts, rebase(state))
    return state, last


def _k1_launch_ms(st: TrackingSetup, device: torch.device,
                  n: int = 20) -> float:
    """K1's ms per launch alone on the setup's inputs (rebased state0),
    n launches timed together after a warm-up one."""
    args = kernel_inputs(st.chunk, st.tab, st.consts, rebase(st.state0))
    tk.track_chunk_fused(*args, **st.kw)

    def run():
        for _ in range(n):
            tk.track_chunk_fused(*args, **st.kw)

    return _timed_s(run, device) * 1e3 / n


def k1_residency(C: int, blkp: int, device: torch.device) -> dict:
    """K1's residency at C channels (one CTA per channel): CTAs resident
    per SM (tk.fused_info) and waves of CTAs over the card's SMs. Empty
    on the CPU."""
    if device.type != "cuda":
        return {}
    per_sm = tk.fused_info(blkp)["ctas_per_sm"]
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    return {"ctas_per_sm": per_sm, "sms": n_sms,
            "waves": math.ceil(C / (per_sm * n_sms))}


def bench_tracking(sig: SignalConfig, trk: TrackConfig, C: int,
                   n_blocks: int, k_lo: int = 2, k_hi: int = 10,
                   device="cuda") -> dict:
    """K1's tracking throughput at C channels x n_blocks 1 ms blocks:
    realtime_factor (seconds of signal per second over C channels, from
    the chain's slope), ms per chained call (rebase + the tracker), K1's
    ms per launch alone, and its residency."""
    dev = resolve_device(device)
    st = tracking_setup(sig, trk, C, n_blocks, dev)
    state = [st.state0]

    def run_k(K):
        state[0], _ = tracking_chain(st, state[0], K)

    per_call = _slope_time(run_k, k_lo, k_hi, device=dev)
    return {"realtime_factor": (n_blocks / 1000.0) / per_call,
            "ms_per_chained_call": per_call * 1e3,
            "k1_ms_per_launch": _k1_launch_ms(st, dev),
            **k1_residency(C, sig.samples_per_code + 2, dev)}


def acquisition_sky() -> list:
    """bench.py::bench_acquisition's 4 satellites."""
    return [SatParams(prn=p, doppler_hz=450.0 * (p - 3),
                      code_phase_chips=101.0 * p, cn0_dbhz=45.0)
            for p in (3, 9, 17, 25)]


def acquisition_setup(sig: SignalConfig, n_searches: int, device,
                      samples=None) -> tuple:
    """bench.py::bench_acquisition's inputs on the device: (windows f32
    [n_searches, 2, 2 code periods, 2], conj code spectra complex64
    [32, Npad], Doppler grid f32 [29]). Search i takes the 1 ms windows
    starting at code periods 3i and 3i + 1 of the seed-7 signal
    (`samples` [N, 2] replaces it)."""
    dev = resolve_device(device)
    spc = sig.samples_per_code
    lw = fft_acquire.window_len(spc, 1)
    dopp = torch.as_tensor(fft_acquire.doppler_grid(sig.if_freq, 14e3,
                                                    500.0),
                           dtype=torch.float32, device=dev)
    fd_re, fd_im = fft_acquire.code_fd_table(
        sig.signal, sig.fs, sig.code_freq, sig.code_length, 1)
    fd = torch.complex(torch.from_numpy(fd_re),
                       torch.from_numpy(fd_im)).to(dev)
    if samples is None:
        x = IFSimulator(sig, acquisition_sky(), noise_sigma=1.0, seed=7,
                        device=dev).generate_tensor(3 * n_searches + 2)
    else:
        x = torch.as_tensor(np.array(samples, np.float32), device=dev)
    wins = torch.stack([
        torch.stack([x[3 * i * spc: 3 * i * spc + lw],
                     x[(3 * i + 1) * spc: (3 * i + 1) * spc + lw]])
        for i in range(n_searches)])
    return wins, fd, dopp


def search_chain(sig: SignalConfig, wins, fd, dopp, K: int
                 ) -> torch.Tensor:
    """K cold searches, one per window pair: each cube's maximum [K]."""
    spc = sig.samples_per_code
    return torch.stack([
        fft_acquire.acquire_cube(wins[i], fd, dopp, sig.fs, spc).max()
        for i in range(K)])


def bench_acquisition(sig: SignalConfig, k_lo: int = 4, k_hi: int = 24,
                      device="cuda") -> dict:
    """The full 32-PRN cold search: 14 kHz band / 500 Hz bins, 2
    alternating 1 ms coherent windows (the reference acquisition
    defaults), on torch.fft (there is no fft_mode: the TPU's split-complex
    modes are not ported)."""
    dev = resolve_device(device)
    wins, fd, dopp = acquisition_setup(sig, k_hi, dev)
    per_search = _slope_time(
        lambda K: search_chain(sig, wins, fd, dopp, K), k_lo, k_hi,
        device=dev)
    n_prn, n_dopp, spc = fd.shape[0], dopp.shape[0], sig.samples_per_code
    return {
        "search_ms": round(per_search * 1e3, 3),
        "cells_per_s": round(n_prn * n_dopp * spc / per_search),
        "grid": [int(n_prn), int(n_dopp), int(spc)],
        "searches_per_s": round(1.0 / per_search, 1),
        "fft_mode": "torch_fft",
    }


class _StageCollector:
    """Aggregate task_health stage timers + PVT/eph records from the
    telemetry bus (bench.py's, line for line: the per-stage breakdown
    ships in the artifact)."""

    def __init__(self):
        self.rows = []                 # (epoch_ms, stage, wall_s, read)
        self.track_wall = []           # (epoch_ms, perf_counter at emit)
        self.pvt = []                  # (epoch_ms, lat, lon, h, n_sv)
        self.eph_events = 0
        self.enabled = False

    def __call__(self, rec):
        if not self.enabled:
            return
        t = rec.get("type")
        if t == "task_health":
            self.rows.append((rec["epoch_ms"], rec["stage"],
                              rec["wall_s"], rec.get("read_s", 0.0)))
            if rec["stage"] == "track":
                self.track_wall.append((rec["epoch_ms"],
                                        time.perf_counter()))
        elif t == "pvt":
            self.pvt.append((rec["epoch_ms"], rec["lat_deg"],
                             rec["lon_deg"], rec["h_m"], rec["n_sv"]))
        elif (t == "event"
              and rec.get("what") == "ephemeris_decoded"):
            self.eph_events += 1

    def breakdown(self, lo_ms, hi_ms):
        out = {}
        for ems, stage, wall, read_s in self.rows:
            if lo_ms <= ems < hi_ms:
                d = out.setdefault(stage, [0.0, 0])
                d[0] += wall
                d[1] += 1
                if stage == "upload" and read_s:
                    r = out.setdefault("read", [0.0, 0])
                    r[0] += read_s
                    r[1] += 1
        return {k: {"s": round(v[0], 4), "n": v[1]}
                for k, v in sorted(out.items())}


def _link_upload_mbps(device: torch.device):
    """MiB/s of one 2 MiB copy from pageable host memory to the card
    (the manager uploads a host chunk from pinned staging instead,
    runtime/feed_stage.py); None on the CPU (no link)."""
    if device.type != "cuda":
        return None
    up = np.zeros(2 * 1024 * 1024, np.int8)
    torch.from_numpy(up).to(device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    torch.from_numpy(up).to(device)
    torch.cuda.synchronize(device)
    return round(2.0 / max(time.perf_counter() - t0, 1e-9), 1)


def bench_manager(sig: SignalConfig, seconds: int = GPS_SECONDS,
                  n_channels: int = GPS_CHANNELS,
                  epoch_ms: int = GPS_EPOCH_MS, sync_every: int = GPS_SYNC,
                  wire: str = "sm2", reacq_period_ms: int = GPS_REACQ_MS,
                  prefetch: bool = True, device_resident: bool = False,
                  readback: str = "compact", navigate: bool = True,
                  device="cuda") -> dict:
    """Sustained end to end: the pipelined ChannelManager (K1, superepoch
    batching, the 2-bit sm2 wire unpacked on the device) over a
    geometry-true signal made before the run: host feed, upload, lock
    supervision, telemetry, live reacquisition searches (the pool holds
    2 absent SVs and one slot stays idle), and with navigate=True the
    online navigator's frame sync, LNAV decode and LSQ PVT inside the
    measured loop, its history bounded to 36 s. device_resident stages
    the packed bytes on the card once (DevicePackedArraySource) instead
    of uploading each chunk from host memory (PackedArraySource).
    Wall-clock on the card's host; per-stage task_health timers ship in
    the result."""
    dev = resolve_device(device)
    n_ms = seconds * 1000
    sats, prns, recv, absent = gps_sky(sig, n_channels, seconds)
    buf = IFSimulator(sig, sats, noise_sigma=1.0, seed=3,
                      device=dev).generate(n_ms + 800)
    if device_resident:
        src = DevicePackedArraySource(buf, fmt=wire, scale=1.0, device=dev)
    else:
        src = PackedArraySource(buf, fmt=wire, scale=1.0)
    del buf
    pool = prns + absent
    cfg = gps_config(pool, sig, n_channels)
    navr = OnlineNavigator(sig, cfg.nav, mode="lsq") if navigate else None
    coll = _StageCollector()
    tlm = Telemetry(sink=None)
    tlm.subscribe(coll)
    mgr = gps_manager(src, cfg, pool, device=dev, telemetry=tlm,
                      navigator=navr, epoch_ms=epoch_ms,
                      sync_every=sync_every,
                      reacq_period_ms=reacq_period_ms, prefetch=prefetch,
                      readback=readback)
    warm_ms, meas_ms = gps_windows(n_ms, epoch_ms, sync_every)
    mgr.run(warm_ms)                 # warm-up: acquire + first builds
    # One continuous measured run, reported as two half-windows (each a
    # whole number of superepochs; the split instant is the wall stamp of
    # the first harvested superepoch of the second half).
    half_ms = meas_ms // 2
    t_base = mgr.clock_ms            # measured epochs start here
    coll.enabled = True
    mgr._next_reacq_ms = 0           # re-arm a search for window 1
    t0 = time.perf_counter()
    recs = mgr.run(meas_ms)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    coll.enabled = False
    t_half = next((t for ems, t in coll.track_wall
                   if ems >= t_base + half_ms), t1)
    rts = [half_ms / 1000.0 / max(t_half - t0, 1e-9),
           (meas_ms - half_ms) / 1000.0 / max(t1 - t_half, 1e-9)]
    rt_overall = meas_ms / 1000.0 / max(t1 - t0, 1e-9)
    live = int(sum(1 for p in recs[-1].prn if p)) if recs else 0

    nav_info = {"armed": navigate}
    if navigate:
        nav_info["ephemerides_decoded"] = len(navr.decoded)
        nav_info["pvt_solutions"] = len(coll.pvt)
        if coll.pvt:
            _, lat, lon, h, nsv = coll.pvt[-1]
            nav_info["pos_err_m"] = round(
                position_error_m(lat, lon, h, recv), 1)
            nav_info["n_sv_last"] = int(nsv)

    note = ("wall-clock on the card's host incl. host feed, packed upload "
            "over PCIe per superepoch, live reacq searches, "
            "per-superepoch readback, live nav decode + PVT")
    if device_resident:
        note = ("same receiver loop, packed signal staged on the card "
                "once (zero per-chunk upload); readback + supervision + "
                "live nav still real")
    return {
        "realtime_factor": round(max(rts), 2),
        "realtime_factor_windows": [round(r, 2) for r in rts],
        "realtime_factor_overall": round(rt_overall, 2),
        "live_channels_at_end": live,
        "engine": mgr.engine,
        "epoch_ms": epoch_ms,
        "sync_every": sync_every,
        "wire": wire,
        "prefetch": prefetch,
        "readback": readback,
        "device_resident": device_resident,
        "reacq_period_ms": reacq_period_ms,
        "navigator": nav_info,
        "stage_breakdown_s_first_half": coll.breakdown(
            t_base, t_base + half_ms),
        "stage_breakdown_s_second_half": coll.breakdown(
            t_base + half_ms, t_base + meas_ms),
        "measured_ms": meas_ms,
        "link_upload_mbps": _link_upload_mbps(dev),
        "note": note,
    }


#: (channels, blocks per call, k_lo, k_hi) of main's tracking runs: the
#: headline first, then the scaling curve (bench.py::main).
TRACKING_RUNS = ((12, 1000, 2, 10), (48, 500, 1, 5), (192, 500, 1, 5),
                 (768, 500, 1, 5))


def main(device="cuda") -> dict:
    """Run every measurement on `device`, print the one JSON line and
    return it as a dict."""
    dev = resolve_device(device)
    sig, trk = GPS_SIG, GPS_TRK
    runs = {C: bench_tracking(sig, trk, C=C, n_blocks=n, k_lo=lo, k_hi=hi,
                              device=dev)
            for C, n, lo, hi in TRACKING_RUNS}
    head_c = TRACKING_RUNS[0][0]
    headline = runs[head_c]["realtime_factor"]
    scaling = {str(C): round(r["realtime_factor"], 1)
               for C, r in runs.items() if C != head_c}
    scaling[str(head_c)] = round(headline, 1)

    acq = bench_acquisition(sig, device=dev)
    mgr = bench_manager(sig, device=dev)
    mgr_dev = bench_manager(sig, device_resident=True, device=dev)

    res = {
        "metric": "gps_l1_12ch_tracking_realtime_factor",
        "value": round(headline, 1),
        "unit": "x_realtime_2.048Msps",
        "vs_baseline": round(headline / 1.0, 1),
        "extra": {
            "method": "K-chained slope, CUDA events around each chain "
                      "queued behind a spin kernel (card time; excludes "
                      "the host's dispatch and any readback)",
            "device": {"name": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                       "count": (torch.cuda.device_count()
                                 if dev.type == "cuda" else 0)},
            "tracking_scaling_channels_rt": scaling,
            "tracking_k1_by_channels": {
                str(C): {k: (round(v, 4) if isinstance(v, float) else v)
                         for k, v in r.items()}
                for C, r in runs.items()},
            "acquisition_32prn_cold_search": acq,
            "acquisition_by_fft_mode": {"torch_fft": {
                "search_ms": acq["search_ms"],
                "cells_per_s": acq["cells_per_s"]}},
            "manager_end_to_end": mgr,
            "manager_device_resident": mgr_dev,
        },
    }
    print(json.dumps(res), flush=True)
    return res
