"""Diagnostic plots: probe, acquisition, tracking, navigation.

The framework's replacement for the reference's de-facto assertion layer
(SURVEY.md §4: plot scripts are the human-inspected checks) — Scilab
probeData.sci, plotAcquisition.sci, plotTracking.sci, plotNavigation.sci
and the wxWidgets gse panels. Renders PNG files with matplotlib (Agg);
every function takes framework result objects directly.

Copied from gnsstpu/viz.py; only the import prefix differs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def probe_data(source, sig, out_png: str, n_ms: int = 10) -> None:
    """Raw-signal probe: time series, histogram, PSD (probeData.sci)."""
    n = int(n_ms * sig.fs * 1e-3)
    x = source.read(0, n)
    fig, axs = plt.subplots(2, 2, figsize=(11, 7))
    t_us = np.arange(min(n, 400)) / sig.fs * 1e6
    axs[0, 0].plot(t_us, x[: len(t_us), 0], lw=0.8, label="I")
    axs[0, 0].plot(t_us, x[: len(t_us), 1], lw=0.8, label="Q", alpha=0.7)
    axs[0, 0].set(title="Time domain", xlabel="time [µs]")
    axs[0, 0].legend()
    axs[0, 1].hist(x[:, 0], bins=64)
    axs[0, 1].set(title="Histogram (I)")
    z = x[:, 0] + 1j * x[:, 1]
    seg = 4096
    k = len(z) // seg
    psd = np.mean(np.abs(np.fft.fft(
        z[: k * seg].reshape(k, seg), axis=1)) ** 2, axis=0)
    f = np.fft.fftfreq(seg, 1.0 / sig.fs)
    order = np.argsort(f)
    axs[1, 0].semilogy(f[order] / 1e6, psd[order], lw=0.8)
    axs[1, 0].set(title="PSD", xlabel="freq [MHz]")
    axs[1, 1].scatter(x[:2000, 0], x[:2000, 1], s=2, alpha=0.3)
    axs[1, 1].set(title="I/Q constellation")
    fig.suptitle(f"probe: {getattr(source, 'path', type(source).__name__)}")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def plot_acquisition(acq, out_png: str,
                     threshold: Optional[float] = None) -> None:
    """Per-PRN peak metric bars (plotAcquisition.sci)."""
    P = len(acq.peak_metric)
    fig, ax = plt.subplots(figsize=(11, 4))
    colors = ["tab:green" if d else "tab:blue" for d in acq.detected]
    ax.bar(np.arange(1, P + 1), acq.peak_metric, color=colors)
    if threshold is not None:
        ax.axhline(threshold, color="r", ls="--", lw=1,
                   label=f"threshold {threshold}")
        ax.legend()
    ax.set(xlabel="PRN / channel", ylabel="peak / 2nd peak",
           title="Acquisition metric")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def plot_tracking(tr, chan: int, out_png: str) -> None:
    """Per-channel tracking panel (plotTracking.sci): prompt I/Q scatter,
    nav-bit stream, discriminators, E/P/L envelopes, Doppler."""
    i_p, q_p = tr.i_p[chan], tr.q_p[chan]
    t = np.arange(len(i_p)) * 1e-3
    fig, axs = plt.subplots(3, 2, figsize=(12, 9))
    axs[0, 0].scatter(i_p, q_p, s=2, alpha=0.3)
    axs[0, 0].set(title="Discrete-time constellation", xlabel="I_P",
                  ylabel="Q_P")
    axs[0, 1].plot(t, i_p, lw=0.6)
    axs[0, 1].set(title="Nav bits (I_P)", xlabel="s")
    axs[1, 0].plot(t, tr.dll_disc[chan], lw=0.5)
    axs[1, 0].set(title="DLL discriminator")
    axs[1, 1].plot(t, tr.pll_disc[chan], lw=0.5)
    axs[1, 1].set(title="PLL discriminator")
    e = np.hypot(tr.i_e[chan], tr.q_e[chan])
    p = np.hypot(i_p, q_p)
    l = np.hypot(tr.i_l[chan], tr.q_l[chan])
    axs[2, 0].plot(t, e, lw=0.5, label="E")
    axs[2, 0].plot(t, p, lw=0.5, label="P")
    axs[2, 0].plot(t, l, lw=0.5, label="L")
    axs[2, 0].legend()
    axs[2, 0].set(title="Correlation envelopes")
    axs[2, 1].plot(t, tr.carr_freq[chan], lw=0.6)
    axs[2, 1].set(title="Carrier frequency [Hz]", xlabel="s")
    fig.suptitle(f"channel {chan} PRN {int(tr.prn[chan])}")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def plot_navigation(nav, out_png: str) -> None:
    """Navigation panel (plotNavigation.sci): UTM E/N scatter around the
    mean, height and clock-bias series, DOP, satellite count."""
    v = nav.valid
    fig, axs = plt.subplots(2, 2, figsize=(11, 8))
    if np.any(v):
        e = nav.utm_e[v] - np.mean(nav.utm_e[v])
        n = nav.utm_n[v] - np.mean(nav.utm_n[v])
        axs[0, 0].scatter(e, n, s=8)
        axs[0, 0].set(title="UTM scatter vs mean [m]", xlabel="E",
                      ylabel="N", aspect="equal")
        t = nav.t_ms[v] / 1e3
        axs[0, 1].plot(t, nav.height[v], ".-")
        axs[0, 1].set(title="Height [m]", xlabel="s")
        axs[1, 0].plot(t, nav.dop[v][:, 0], ".-", label="GDOP")
        axs[1, 0].plot(t, nav.dop[v][:, 2], ".-", label="HDOP")
        axs[1, 0].legend()
        axs[1, 0].set(title="DOP", xlabel="s")
    axs[1, 1].plot(nav.t_ms / 1e3, nav.n_sats, ".-")
    axs[1, 1].set(title="satellites used", xlabel="s")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


# ---------------------------------------------------------------------------
# Analysis panel set — the reference's MATLAB log-analysis scripts
# (REALTIME .../matlab/*.m: get_/plot_/analyze_ pseudo, pvt, ekf, pps)
# rebuilt over framework result objects and the JSONL telemetry stream.
# ---------------------------------------------------------------------------


def plot_pseudoranges(nav, out_png: str) -> None:
    """Pseudorange/clock analysis (matlab plot_pseudo.m / analyze_pseudo.m
    analogue): receiver clock bias and drift series, ECEF position
    stability, velocity magnitude."""
    v = nav.valid
    t = nav.t_ms / 1e3
    fig, axs = plt.subplots(2, 2, figsize=(11, 8))
    axs[0, 0].plot(t[v], nav.dt[v], ".-")
    axs[0, 0].set(title="receiver clock bias [m]", xlabel="s")
    if len(nav.ddt) and np.any(getattr(nav, "vel_valid", [])):
        w = nav.vel_valid
        axs[0, 1].plot(nav.t_ms[w] / 1e3, nav.ddt[w], ".-")
        axs[0, 1].set(title="clock drift [m/s]", xlabel="s")
        speed = np.sqrt(nav.vx[w] ** 2 + nav.vy[w] ** 2 + nav.vz[w] ** 2)
        axs[1, 1].plot(nav.t_ms[w] / 1e3, speed, ".-")
        axs[1, 1].set(title="speed [m/s] (gse speedo)", xlabel="s")
    for arr, lbl in ((nav.x, "x"), (nav.y, "y"), (nav.z, "z")):
        if np.any(v):
            axs[1, 0].plot(t[v], arr[v] - np.mean(arr[v]), ".-", label=lbl)
    axs[1, 0].legend()
    axs[1, 0].set(title="ECEF vs mean [m]", xlabel="s")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def plot_ekf(steps, out_png: str) -> None:
    """EKF analysis (matlab plot_ekf.m / gse gui_ekf analogue): position/
    velocity/clock state history + innovation/acceptance statistics from
    a list of nav.ekf.EkfStep records."""
    t = np.arange(len(steps))
    pos = np.stack([s.pos for s in steps])
    vel = np.stack([s.vel for s in steps])
    bias = np.array([s.clock_bias_m for s in steps])
    drift = np.array([s.clock_drift_ms for s in steps])
    rms = np.array([float(np.sqrt(np.mean(np.square(s.innovations))))
                    if len(np.atleast_1d(s.innovations)) else 0.0
                    for s in steps])
    acc = np.array([float(np.mean(s.accepted))
                    if len(np.atleast_1d(s.accepted)) else 1.0
                    for s in steps])
    fig, axs = plt.subplots(2, 2, figsize=(11, 8))
    for i, lbl in enumerate("xyz"):
        axs[0, 0].plot(t, pos[:, i] - pos[0, i], label=lbl)
        axs[0, 1].plot(t, vel[:, i], label="v" + lbl)
    axs[0, 0].legend(), axs[0, 0].set(title="EKF position vs start [m]")
    axs[0, 1].legend(), axs[0, 1].set(title="EKF velocity [m/s]")
    axs[1, 0].plot(t, bias, label="bias [m]")
    axs[1, 0].plot(t, drift, label="drift [m/s]")
    axs[1, 0].legend(), axs[1, 0].set(title="EKF clock states")
    axs[1, 1].plot(t, rms, ".-", label="innovation RMS [m]")
    axs[1, 1].plot(t, acc, ".-", label="accept frac")
    axs[1, 1].legend()
    axs[1, 1].set(title="innovations / measurement screening",
                  xlabel="step")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def plot_ekf_log(jsonl_path: str, out_png: str) -> bool:
    """EKF panel from a LIVE telemetry log ('ekf' record family emitted
    by OnlineNavigator(mode='ekf') — gse gui_ekf / matlab analyze_ekf.m
    over the live stream). Returns False when the log has no ekf records."""
    import json as _json

    recs = []
    with open(jsonl_path) as f:
        for line in f:
            if line.strip():
                r = _json.loads(line)
                if r.get("type") == "ekf":
                    recs.append(r)
    if not recs:
        return False
    t = np.array([r["epoch_ms"] for r in recs]) / 1e3
    pos = np.stack([[r["x"], r["y"], r["z"]] for r in recs])
    vel = np.stack([[r["vx"], r["vy"], r["vz"]] for r in recs])
    fig, axs = plt.subplots(2, 2, figsize=(11, 8))
    for i, lbl in enumerate("xyz"):
        axs[0, 0].plot(t, pos[:, i] - pos[0, i], label=lbl)
        axs[0, 1].plot(t, vel[:, i], label="v" + lbl)
    axs[0, 0].legend(), axs[0, 0].set(title="EKF position vs start [m]")
    axs[0, 1].legend(), axs[0, 1].set(title="EKF velocity [m/s]")
    axs[1, 0].plot(t, [r["clk_m"] for r in recs], label="bias [m]")
    axs[1, 0].plot(t, [r["clk_drift_ms"] for r in recs],
                   label="drift [m/s]")
    axs[1, 0].legend(), axs[1, 0].set(title="EKF clock states")
    axs[1, 1].plot(t, [r["n_used"] for r in recs], ".-", label="n used")
    axs[1, 1].plot(t, [r["p_pos"] for r in recs], ".-",
                   label="pos sigma [m]")
    axs[1, 1].legend()
    axs[1, 1].set(title="measurements / covariance", xlabel="t [s]")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return True


def plot_health(jsonl_path: str, out_png: str) -> None:
    """Run-health analysis from the telemetry stream (matlab
    analyze_pvt.m + gse gui_health analogue): per-stage wall times,
    per-PRN C/N0 and Doppler timelines, FIFO depth."""
    import collections
    import json as _json

    stages = collections.defaultdict(lambda: ([], []))
    chans = collections.defaultdict(lambda: ([], [], []))
    fifo_t, fifo_n = [], []
    with open(jsonl_path) as f:
        for line in f:
            if not line.strip():
                continue
            r = _json.loads(line)
            if r["type"] == "task_health":
                if r.get("stage") == "source":
                    fifo_t.append(r.get("epoch_ms", 0) / 1e3)
                    fifo_n.append(r.get("count", 0))
                else:
                    s = stages[r["stage"]]
                    s[0].append(r.get("epoch_ms", 0) / 1e3)
                    s[1].append(r["wall_s"] * 1e3)
            elif r["type"] == "channel_health" and r.get("prn"):
                c = chans[r["prn"]]
                c[0].append(r["epoch_ms"] / 1e3)
                c[1].append(r["cn0_dbhz"])
                c[2].append(r["doppler_hz"])
    fig, axs = plt.subplots(2, 2, figsize=(11, 8))
    for name, (t, w) in sorted(stages.items()):
        axs[0, 0].plot(t, w, ".-", label=name)
    axs[0, 0].legend(), axs[0, 0].set(
        title="stage wall time [ms] (TASK_HEALTH)", xlabel="s")
    for prn, (t, cn0, dop) in sorted(chans.items()):
        axs[0, 1].plot(t, cn0, ".-", label=f"PRN {prn}")
        axs[1, 0].plot(t, dop, ".-", label=f"PRN {prn}")
    axs[0, 1].legend(fontsize=7), axs[0, 1].set(title="C/N0 [dB-Hz]",
                                                xlabel="s")
    axs[1, 0].legend(fontsize=7), axs[1, 0].set(title="Doppler [Hz]",
                                                xlabel="s")
    if fifo_t:
        axs[1, 1].plot(fifo_t, fifo_n, ".-")
    axs[1, 1].set(title="stream FIFO depth", xlabel="s")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
