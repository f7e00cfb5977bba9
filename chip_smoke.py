"""Smoke run of the PyTorch + CUDA port (gnsstpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the live GPS L1 C/A receiver's main path once on the card, through
the entry points a user calls, at the benchmark configuration
(bench.py::bench_manager): 2.048 Msps complex, 12 channels over an
11-satellite geometry-true sky plus 2 absent PRNs in the pool, 500 ms
epochs, 8-epoch superepochs, 2-bit sm2 wire resident on the card,
prefetch pipeline, compact readback, 1 s reacquisition, and the online
navigator (LNAV decode + LSQ PVT), over ~44 s of signal made by the
port's simulator from a fixed seed.

Phases (each prints one line; any failure raises and exits non-zero):
  1. device: a CUDA card is required; its name and power limit;
  2. build: the port's CUDA kernels from the sources in this checkout;
  3. K1 on the card against its plain PyTorch twin (C=12 x 500 blocks and
     C=9 x 6 blocks, tests/test_track_kernel.py's tolerances);
  4. K1 time against the twin (CUDA events, C=12 x 1000 and x 500
     blocks) and the time of one on-chunk acquisition search;
  5. the main path (warm-up run, then a measured run) with its
     end-to-end checks and K1's launch count;
then the kernel record, the nvidia-smi line and the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from gnsstpu_torch import (AcqConfig, NavConfig, ReceiverConfig,
                           SignalConfig, TrackConfig)
from gnsstpu_torch.acquisition import search
from gnsstpu_torch.device import u32_numpy, u32_tensor
from gnsstpu_torch.ops import fft_acquire
from gnsstpu_torch.ops import track_kernel as tk
from gnsstpu_torch.runtime import OnlineNavigator, Telemetry
from gnsstpu_torch.runtime.manager import ChannelManager
from gnsstpu_torch.runtime.sources import DevicePackedArraySource
from gnsstpu_torch.sim import IFSimulator, SatParams
from gnsstpu_torch.sim.scenario import bench_constellation, position_error_m
from gnsstpu_torch.tracking import fused as tfused
from gnsstpu_torch.tracking import scan as tscan

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
TRK = TrackConfig(dll_bw=1.0, el_spacing=0.3, pll_bw=25.0, fll_bw=250.0)
K1_SOURCE = "gnsstpu_torch/csrc/track_fused.cu"
K1_REPLACES = "gnsstpu/ops/track_kernel.py:274"


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def k1_inputs(C: int, n_blocks: int, device):
    """K1's tensor and static arguments for test_track_kernel.py's
    _setup widened to C channels, with the signal from the port's
    simulator."""
    prns = [3, 9, 17, 25, 5, 12, 22, 28, 31, 7, 1, 14][:C]
    sats = [SatParams(prn=p, doppler_hz=400.0 * i - 600.0,
                      code_phase_chips=50.0 * i + 11.0, cn0_dbhz=49.0)
            for i, p in enumerate(prns)]
    chunk = IFSimulator(SIG, sats, noise_sigma=1.0, seed=4,
                        device=device).generate_tensor(n_blocks + 3)
    tab = torch.as_tensor(tfused.fused_code_table(SIG, TRK, prns),
                          device=device)
    cb, ia = tscan.channel_consts(SIG, TRK, prns)
    spchip = SIG.fs / SIG.code_freq
    state0 = tscan.TrackState.init(
        np.array([int(round(s.code_phase_chips * spchip)) for s in sats]),
        np.array([s.doppler_hz + 37.0 for s in sats], np.float32),
        device=device)
    consts = (u32_tensor(cb, device), torch.as_tensor(ia, device=device))
    args = tfused.kernel_inputs(chunk, tab, consts, state0)
    return args, tfused.kernel_kwargs(SIG, TRK, n_blocks=n_blocks)


def k1_compare(C: int, n_blocks: int, device) -> dict:
    """K1's wrapper against its plain twin on the same inputs on the
    card; raises on a breach of test_track_kernel.py's tolerances.
    Returns the largest deviation of each checked quantity."""
    args, kw = k1_inputs(C, n_blocks, device)
    k_out, _, k_pos, k_cph = tk.track_chunk_fused(*args, **kw)
    r_out, _, r_pos, r_cph = tk.track_chunk_fused_ref(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(k_out[..., tk.O_BLKSIZE], r_out[..., tk.O_BLKSIZE]):
        raise AssertionError(f"K1 C={C}: blksize differs from the twin")
    if not torch.equal(k_pos, r_pos):
        raise AssertionError(f"K1 C={C}: sample_pos differs from the twin")
    dev = {"blksize_sample_pos": "exact"}
    dph = u32_numpy(k_cph).astype(np.int64) - u32_numpy(r_cph).astype(
        np.int64)
    dph = (dph + 2 ** 31) % 2 ** 32 - 2 ** 31
    dev["carr_phase_lsb"] = int(np.max(np.abs(dph)))
    if dev["carr_phase_lsb"] > 4 * n_blocks * (SIG.samples_per_code + 2):
        raise AssertionError(f"K1 C={C}: carrier phase beyond the "
                             "1-LSB-per-block bound")
    ko, ro = k_out.cpu().numpy(), r_out.cpu().numpy()
    lanes = [tk.O_IE, tk.O_QE, tk.O_IP, tk.O_QP, tk.O_IL, tk.O_QL]
    np.testing.assert_allclose(ko[..., lanes], ro[..., lanes], rtol=2e-3,
                               atol=2.0, err_msg=f"K1 C={C} accumulators")
    dev["acc_abs"] = float(np.max(np.abs(ko[..., lanes] - ro[..., lanes])))
    for name, lane, atol in (("carr_doppler", tk.O_CARR_DOPPLER, 0.05),
                             ("rem_code_phase", tk.O_REM, 5e-4)):
        np.testing.assert_allclose(ko[..., lane], ro[..., lane], rtol=0,
                                   atol=atol, err_msg=f"K1 C={C} {name}")
        dev[name] = float(np.max(np.abs(ko[..., lane] - ro[..., lane])))
    return dev


def k1_times(C: int, n_blocks: int, device, reps: int = 20) -> tuple:
    """(kernel ms, plain twin ms) per call on the same inputs, timed with
    CUDA events after a warm-up call of each."""
    args, kw = k1_inputs(C, n_blocks, device)

    def timed(fn, n):
        fn(*args, **kw)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn(*args, **kw)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / n

    return (timed(tk.track_chunk_fused, reps),
            timed(tk.track_chunk_fused_ref, 1))


def acq_search_ms(device, reps: int = 20) -> float:
    """One on-chunk cold search of the main path (32 PRNs x 33 Doppler
    bins x 2048 lags, two 2 ms coherent windows, max-combined): ms per
    search, CUDA events after a warm-up."""
    acq = AcqConfig(doppler_band=8e3, coherent_ms=2, threshold=2.4)
    spc = SIG.samples_per_code
    x = IFSimulator(SIG, [SatParams(prn=3, doppler_hz=1250.0,
                                    code_phase_chips=100.3)],
                    noise_sigma=1.0, seed=7, device=device
                    ).generate_tensor(8)
    blocks = search.stack_windows(x, spc, acq)
    fd = search.code_fd_tensor(SIG, acq, device)
    dopp = torch.as_tensor(fft_acquire.doppler_grid(
        0.0, acq.doppler_band, acq.doppler_bin_step()),
        dtype=torch.float32, device=device)

    def once():
        cube = fft_acquire.acquire_cube(blocks, fd, dopp, SIG.fs, spc)
        return fft_acquire.peak_metrics(cube, samples_per_code=spc,
                                        samples_per_chip=2)["metric"]

    once()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        once()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


class _Collector:
    """PVT records and per-stage host wall time (task_health) of the
    measured window, from the telemetry bus."""

    def __init__(self):
        self.pvt = []
        self.stages = {}
        self.enabled = False

    def __call__(self, rec):
        if not self.enabled:
            return
        if rec.get("type") == "pvt":
            self.pvt.append((rec["epoch_ms"], rec["lat_deg"],
                             rec["lon_deg"], rec["h_m"], rec["n_sv"]))
        elif rec.get("type") == "task_health":
            self.stages[rec["stage"]] = (self.stages.get(rec["stage"], 0.0)
                                         + rec["wall_s"])


def main_path(device) -> dict:
    """The bench_manager configuration through the port's manager."""
    seconds, n_channels, epoch_ms, sync_every = 44, 12, 500, 8
    n_ms = seconds * 1000
    sats, prns, recv = bench_constellation(SIG, n_channels - 1,
                                           duration_s=seconds + 1.0)
    t0 = time.perf_counter()
    buf = IFSimulator(SIG, sats, noise_sigma=1.0, seed=3,
                      device=device).generate(n_ms + 800)
    src = DevicePackedArraySource(buf, fmt="sm2", scale=1.0, device=device)
    del buf
    setup_s = time.perf_counter() - t0
    absent = [p for p in range(1, 33) if p not in prns][:2]
    pool = prns + absent
    cfg = ReceiverConfig(
        signal=SIG,
        acq=AcqConfig(doppler_band=8e3, coherent_ms=2, threshold=2.4,
                      prn_list=tuple(pool)),
        track=TRK,
        nav=NavConfig(sol_period_ms=1000, elevation_mask_deg=5.0,
                      use_tropo=False),
        n_channels=n_channels)
    navr = OnlineNavigator(SIG, cfg.nav, mode="lsq")
    coll = _Collector()
    tlm = Telemetry(sink=None)
    tlm.subscribe(coll)
    warm_ms = 2 * sync_every * epoch_ms
    tk.reset_launches()
    mgr = ChannelManager(
        src, cfg, device=device, telemetry=tlm, epoch_ms=epoch_ms,
        reacq_period_ms=1000, sync_every=sync_every, navigator=navr,
        prn_pool=pool, prefetch=True, readback="compact",
        history_window_ms=36_000, engine="fused")
    mgr.run(warm_ms)
    sup_ms = sync_every * epoch_ms
    meas_ms = ((n_ms - warm_ms - epoch_ms) // (2 * sup_ms)) * 2 * sup_ms
    coll.enabled = True
    mgr._next_reacq_ms = 0           # re-arm a search for the window
    t0 = time.perf_counter()
    recs = mgr.run(meas_ms)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    coll.enabled = False
    launches = tk.LAUNCHES["track_chunk_fused"]
    res = {
        "realtime_factor_overall": meas_ms / 1000.0 / (t1 - t0),
        "measured_ms": meas_ms,
        "wall_s": t1 - t0,
        "signal_setup_s": setup_s,
        "engine": mgr.engine,
        "live_channels_at_end": int(sum(1 for p in recs[-1].prn if p)),
        "ephemerides_decoded": len(navr.decoded),
        "pvt_solutions": len(coll.pvt),
        "k1_launches": launches,
        "stage_wall_s": {k: round(v, 4) for k, v in
                         sorted(coll.stages.items())},
    }
    if coll.pvt:
        _, lat, lon, h, nsv = coll.pvt[-1]
        res["last_fix_err_m"] = position_error_m(lat, lon, h, recv)
        res["n_sv_last"] = int(nsv)
    return res


def main() -> int:
    # 1. Device.
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"[1 device] {name} | nvidia-smi: {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. Build.
    built = tk.build()
    regs = [ln.strip() for ln in built.log.splitlines() if "registers" in ln]
    print(f"[2 build] K1 {built.path.name} built in {built.build_s:.2f} s; "
          f"{regs[0] if regs else 'ptxas: no register report'}", flush=True)

    # 3. K1 against its plain twin on the card.
    dev500 = k1_compare(12, 500, dev)
    dev6 = k1_compare(9, 6, dev)
    print(f"[3 K1 parity] C=12x500: {json.dumps(dev500)} | C=9x6: "
          f"{json.dumps(dev6)}", flush=True)

    # 4. K1 time against the twin.
    k_ms, p_ms = k1_times(12, 1000, dev)
    k500_ms, p500_ms = k1_times(12, 500, dev)
    print(f"[4 K1 time] C=12x1000 blocks (1.000 s of signal): kernel "
          f"{k_ms:.4f} ms (real-time factor {1000.0 / k_ms:.1f}), plain "
          f"twin {p_ms:.2f} ms (real-time factor {1000.0 / p_ms:.2f}); "
          f"C=12x500: kernel {k500_ms:.4f} ms, twin {p500_ms:.2f} ms; "
          f"on-chunk acquisition search {acq_search_ms(dev):.3f} ms",
          flush=True)

    # 5. Main path.
    res = main_path(dev)
    print(f"[5 main path] {json.dumps(res)}", flush=True)
    checks = {
        "live_channels_at_end >= 10": res["live_channels_at_end"] >= 10,
        "ephemerides_decoded >= 8": res["ephemerides_decoded"] >= 8,
        "pvt_solutions >= 10": res["pvt_solutions"] >= 10,
        "last_fix_err_m < 100": res.get("last_fix_err_m", 1e9) < 100.0,
        "k1_launches > 0": res["k1_launches"] > 0,
        "jax not imported": "jax" not in sys.modules,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}")

    print(json.dumps({"kernels": [{
        "name": "track_chunk_fused", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": res["k1_launches"],
        "max_abs_err": dev500["acc_abs"], "ms": k500_ms,
        "plain_ms": p500_ms}]}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
