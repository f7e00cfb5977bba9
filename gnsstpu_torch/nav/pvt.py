"""Pseudoranges + least-squares PVT solution.

Reference semantics:
  - relative pseudoranges from absolute sample indices:
    GPS/L1/calculatePseudoranges.sci:51-74 (min-travel-time rebase +
    startOffset), C++ twin objects/pvt.cpp:759-810.
  - LSQ with Sagnac (e_r_corr), elevation-dependent tropo, DOP:
    GPS/L1/geoFunctions/leastSquarePos.sci:4-70, objects/pvt.cpp:972-1060.
  - epoch orchestration: GPS/L1/postNavigation.sci:40-303 (500 ms epochs,
    elevation mask, transmitTime advance).

Host-side float64 NumPy, vectorized over satellites.

Copied from gnsstpu/nav/pvt.py; only the import prefix differs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from gnsstpu_torch.config import SPEED_OF_LIGHT, NavConfig, SignalConfig
from gnsstpu_torch.nav import geodesy
from gnsstpu_torch.nav.orbits import satpos
from gnsstpu_torch.nav.types import Ephemeris


def calculate_pseudoranges(abs_sample: np.ndarray, ms_of_signal: np.ndarray,
                           samples_per_code: float,
                           start_offset_ms: float,
                           code_period_s: float = 1e-3) -> np.ndarray:
    """Relative pseudoranges [m] at per-channel measurement epochs.

    abs_sample: [C, n_ms] absolute sample index of each code start.
    ms_of_signal: [C] int measurement epoch per channel (index into the
    per-code-period record; one entry = one code period, 1 ms for GPS,
    4 ms for Galileo E1B).
    (calculatePseudoranges.sci:51-74: travel time in code periods, rebased
    to the earliest channel + startOffset, scaled by c*T_code.)
    """
    C = abs_sample.shape[0]
    travel = np.array([abs_sample[c, ms_of_signal[c]] / samples_per_code
                       for c in range(C)], np.float64)
    travel = (travel - np.floor(travel.min())
              + start_offset_ms / (code_period_s * 1e3))
    return travel * (SPEED_OF_LIGHT * code_period_s)


@dataclasses.dataclass
class LsqSolution:
    pos: np.ndarray       # [4] ECEF x, y, z [m] + receiver clock bias [m]
    el: np.ndarray        # [S] deg
    az: np.ndarray        # [S] deg
    dop: np.ndarray       # [5] GDOP PDOP HDOP VDOP TDOP
    residuals: np.ndarray  # [S] post-fit [m]
    ok: bool = True
    used: Optional[np.ndarray] = None  # [S] bool, set by the RAIM wrapper


def least_square_pos(sat_pos: np.ndarray, obs: np.ndarray,
                     use_tropo: bool = True, iterations: int = 7
                     ) -> LsqSolution:
    """Iterative LSQ receiver position (leastSquarePos.sci:4-70).

    sat_pos: [S, 3] ECEF at transmit time; obs: [S] pseudoranges [m]
    (already satellite-clock corrected).
    """
    S = sat_pos.shape[0]
    pos = np.zeros(4)
    az = np.zeros(S)
    el = np.zeros(S)
    A = np.zeros((S, 4))
    omc = np.zeros(S)
    trop = np.full(S, 2.0)
    rot_x = sat_pos.copy()
    for it in range(iterations):
        if it > 0:
            rho = np.linalg.norm(sat_pos - pos[:3], axis=1)
            rot_x = geodesy.e_r_corr(rho / SPEED_OF_LIGHT, sat_pos)
            az, el, _ = geodesy.topocent(pos[:3], rot_x - pos[:3])
            if use_tropo:
                trop = geodesy.tropo(np.sin(np.radians(el)))
            else:
                trop = np.zeros(S)
        rng = np.linalg.norm(rot_x - pos[:3], axis=1)
        omc = obs - rng - pos[3] - trop
        A[:, :3] = -(rot_x - pos[:3]) / obs[:, None]
        A[:, 3] = 1.0
        # lstsq's SVD already yields the rank — a separate
        # matrix_rank() would repeat the decomposition every iteration
        # (this solver runs per measurement epoch in the LIVE loop).
        dx, _res, rank, _sv = np.linalg.lstsq(A, omc, rcond=None)
        if rank != 4:
            return LsqSolution(np.zeros(4), el, az, np.zeros(5), omc,
                               ok=False)
        pos = pos + dx
        # Converged: further iterations only re-add ~machine-noise
        # steps (the reference iterates a fixed nmbOfIterations=7,
        # leastSquarePos.sci:16; the fixed count is its convergence
        # budget, not a semantic).
        if it > 0 and float(np.abs(dx).max()) < 1e-6:
            break
    q = np.linalg.inv(A.T @ A)
    dop = np.array([
        np.sqrt(np.trace(q)),
        np.sqrt(q[0, 0] + q[1, 1] + q[2, 2]),
        np.sqrt(q[0, 0] + q[1, 1]),
        np.sqrt(q[2, 2]),
        np.sqrt(q[3, 3]),
    ])
    resid = obs - np.linalg.norm(rot_x - pos[:3], axis=1) - pos[3] - trop
    return LsqSolution(pos, el, az, dop, resid)


def least_square_pos_multi(sat_pos: np.ndarray, obs: np.ndarray,
                           sys_id: np.ndarray, n_sys: int,
                           use_tropo: bool = True, iterations: int = 7
                           ) -> LsqSolution:
    """Multi-constellation LSQ: one position + one clock bias per
    SYSTEM (GPS time vs GLONASS time etc. differ by an unknown offset
    the solver estimates as extra states — the capability the reference
    ecosystem gestures at with four separate receivers but never had).

    sys_id: [S] integer system index per measurement (0..n_sys-1).
    Returns LsqSolution with pos[3] = system-0 clock bias and
    .inter_sys [n_sys-1] = biases of systems 1.. relative to system 0.
    Needs >= 4 + (n_sys - 1) measurements with every system present.
    """
    S = sat_pos.shape[0]
    nu = 4 + (n_sys - 1)
    sys_id = np.asarray(sys_id, int)
    x = np.zeros(nu)           # [pos, dt0, delta_1..]
    az = np.zeros(S)
    el = np.zeros(S)
    A = np.zeros((S, nu))
    trop = np.full(S, 2.0)
    rot_x = sat_pos.copy()
    clk_col = np.zeros((S, n_sys - 1))
    for s in range(1, n_sys):
        clk_col[sys_id == s, s - 1] = 1.0
    for it in range(iterations):
        if it > 0:
            rho = np.linalg.norm(sat_pos - x[:3], axis=1)
            rot_x = geodesy.e_r_corr(rho / SPEED_OF_LIGHT, sat_pos)
            az, el, _ = geodesy.topocent(x[:3], rot_x - x[:3])
            trop = (geodesy.tropo(np.sin(np.radians(el))) if use_tropo
                    else np.zeros(S))
        rng = np.linalg.norm(rot_x - x[:3], axis=1)
        omc = (obs - rng - x[3] - clk_col @ x[4:] - trop)
        A[:, :3] = -(rot_x - x[:3]) / obs[:, None]
        A[:, 3] = 1.0
        A[:, 4:] = clk_col
        if S < nu or np.linalg.matrix_rank(A) != nu:
            bad = LsqSolution(np.zeros(4), el, az, np.zeros(5), omc,
                              ok=False)
            bad.inter_sys = np.zeros(n_sys - 1)
            return bad
        dx, *_ = np.linalg.lstsq(A, omc, rcond=None)
        x = x + dx
    q = np.linalg.inv(A.T @ A)
    dop = np.array([
        np.sqrt(np.trace(q[:4, :4])),
        np.sqrt(q[0, 0] + q[1, 1] + q[2, 2]),
        np.sqrt(q[0, 0] + q[1, 1]),
        np.sqrt(q[2, 2]),
        np.sqrt(q[3, 3]),
    ])
    resid = (obs - np.linalg.norm(rot_x - x[:3], axis=1) - x[3]
             - clk_col @ x[4:] - trop)
    sol = LsqSolution(x[:4], el, az, dop, resid)
    sol.inter_sys = x[4:].copy()
    return sol


@dataclasses.dataclass
class SystemObs:
    """One constellation's inputs to the joint navigator.

    abs_sample rows must be ABSOLUTE SAMPLE indexes of a clock shared by
    all systems (a multi-band front end samples every channel off one
    oscillator); subframe_start is each channel's decoded anchor index
    (code periods) pre-aligned to tow_s (navigate_from_anchors style).
    """

    prns: list
    abs_sample: np.ndarray       # [C, n_idx]
    subframe_start: list         # [C] anchor index, code periods
    tow_s: float                 # satellite time at the aligned anchors
    ephs: dict                   # prn -> ephemeris
    satpos_fn: object            # (t, [eph]) -> (pos [S,3], clk [S])
    code_period_s: float
    fs: float


def navigate_joint(systems, nav: NavConfig, n_epochs: int,
                   elevation_mask_deg: float = None) -> NavSolutions:
    """Joint multi-constellation epoch navigator (e.g. GPS + GLONASS).

    Solves position + per-system clock biases from the union of
    pseudoranges at a common solution cadence. Each system keeps its own
    transmit timescale (satpos at its own tow_s + k*step); the unknown
    inter-system time offsets are estimated states
    (least_square_pos_multi). Minimum measurement count is
    4 + (n_sys - 1): 3 GPS + 3 GLONASS fixes where neither subset can.

    systems: list of SystemObs. n_epochs: solution epochs to compute.
    Reference: GPS/L1/postNavigation.sci + GLONASS/L1/postNavigation.sci
    — two single-constellation navigators this joint solve supersedes.
    """
    n_sys = len(systems)
    mask = (nav.elevation_mask_deg if elevation_mask_deg is None
            else elevation_mask_deg)
    E = n_epochs
    out = NavSolutions(
        t_ms=np.zeros(E), x=np.zeros(E), y=np.zeros(E), z=np.zeros(E),
        dt=np.zeros(E), latitude=np.zeros(E), longitude=np.zeros(E),
        height=np.zeros(E), utm_e=np.zeros(E), utm_n=np.zeros(E),
        utm_u=np.zeros(E), dop=np.zeros((E, 5)), n_sats=np.zeros(E, int),
        valid=np.zeros(E, bool),
    )
    out.inter_sys = np.zeros((E, n_sys - 1))
    steps = [max(1, int(round(nav.sol_period_ms * 1e-3
                              / s.code_period_s))) for s in systems]
    t_tx = [s.tow_s for s in systems]
    elev: dict = {}
    utm_zone = None
    for k in range(E):
        t_rx_s, sat_p_all, sys_all, prn_all = [], [], [], []
        for si, s in enumerate(systems):
            sf = np.asarray(s.subframe_start, np.int64)
            ms = sf + k * steps[si]
            ok = ms < s.abs_sample.shape[1]
            use = [c for c in np.nonzero(ok)[0]
                   if s.prns[c] in s.ephs
                   and elev.get((si, s.prns[c]), 90.0) >= mask]
            if not use:
                continue
            p, clk = s.satpos_fn(t_tx[si],
                                 [s.ephs[s.prns[c]] for c in use])
            for j, c in enumerate(use):
                # Receive time of the measured code start on the COMMON
                # sample clock, satellite-clock corrected.
                t_rx_s.append(s.abs_sample[c, ms[c]] / s.fs
                              + float(clk[j]))
                sat_p_all.append(p[j])
                sys_all.append(si)
                prn_all.append((si, s.prns[c]))
        out.t_ms[k] = k * nav.sol_period_ms
        out.n_sats[k] = len(t_rx_s)
        if len(t_rx_s) >= 4 + (n_sys - 1):
            t_rx = np.asarray(t_rx_s)
            sysv = np.asarray(sys_all)
            # Rebase PER SYSTEM to a nominal travel-time window (the
            # single-system navigator's startOffset convention): each
            # stream's decode anchors sit at different stream times, and
            # an un-rebased cross-system spread of ~0.1 s would leave
            # the pseudoranges 10x the true ranges (ruining the
            # A ~ los/obs linearization). The removed per-system
            # constants are exactly what the clock states estimate.
            trav = t_rx.copy()
            for s in range(n_sys):
                m = sysv == s
                if np.any(m):
                    trav[m] -= np.floor(trav[m].min() * 1e3) / 1e3
            pr = (trav + nav.start_offset_ms * 1e-3) * SPEED_OF_LIGHT
            sol = least_square_pos_multi(
                np.asarray(sat_p_all), pr, np.asarray(sys_all), n_sys,
                use_tropo=nav.use_tropo, iterations=nav.lsq_iterations)
            if sol.ok:
                for key, e in zip(prn_all, sol.el):
                    elev[key] = e
                out.x[k], out.y[k], out.z[k], out.dt[k] = sol.pos
                out.inter_sys[k] = sol.inter_sys
                out.dop[k] = sol.dop
                lat, lon, h = geodesy.cart2geo(*sol.pos[:3], 5)
                out.latitude[k], out.longitude[k] = lat, lon
                out.height[k] = h
                if utm_zone is None:
                    utm_zone = geodesy.find_utm_zone(lat, lon)
                out.utm_e[k], out.utm_n[k], out.utm_u[k] = \
                    geodesy.cart2utm(*sol.pos[:3], utm_zone)
                out.valid[k] = True
        for si, s in enumerate(systems):
            t_tx[si] += steps[si] * s.code_period_s
    return out


def least_square_vel(sat_pos: np.ndarray, sat_vel: np.ndarray,
                     rx_pos: np.ndarray, doppler_hz: np.ndarray,
                     wavelength_m: np.ndarray) -> "VelSolution":
    """Snapshot receiver velocity + clock drift from carrier Doppler.

    Range-rate model: rho_dot_s = e_s . (v_sat_s - v_rx) + c*ddt with
    e_s the receiver->satellite unit vector; the measured range rate is
    -lambda_s * D_s (positive Doppler = closing). Solves the linear system
    with the same geometry matrix as the position LSQ. The reference
    carries Doppler into its nav filter as pseudorange-rate measurements
    (gse EKF velocity states; objects/pvt.cpp Navigate uses NCO carrier
    frequency for rate aiding); this is the snapshot-LSQ equivalent.

    sat_pos: [S,3] m; sat_vel: [S,3] m/s; rx_pos: [3] m (from the position
    fix); doppler_hz: [S] carrier Doppler; wavelength_m: [S] per-satellite
    carrier wavelength (FDMA signals differ per channel).
    Returns VelSolution(vel [3] m/s, ddt m/s, residuals [S] m/s).
    """
    los = sat_pos - rx_pos[None, :]
    e = los / np.linalg.norm(los, axis=1, keepdims=True)
    S = sat_pos.shape[0]
    A = np.zeros((S, 4))
    A[:, :3] = -e
    A[:, 3] = 1.0
    rate_meas = -np.asarray(wavelength_m) * np.asarray(doppler_hz)
    b = rate_meas - np.sum(e * sat_vel, axis=1)
    if S < 4 or np.linalg.matrix_rank(A) != 4:
        return VelSolution(np.zeros(3), 0.0, np.zeros(S), ok=False)
    x, *_ = np.linalg.lstsq(A, b, rcond=None)
    resid = b - A @ x
    return VelSolution(x[:3], float(x[3]), resid)


@dataclasses.dataclass
class VelSolution:
    vel: np.ndarray        # [3] ECEF m/s
    ddt: float             # receiver clock drift [m/s]
    residuals: np.ndarray  # [S] post-fit range-rate residuals [m/s]
    ok: bool = True


def cross_correlation_suspects(cn0_dbhz: np.ndarray,
                               doppler_hz: np.ndarray,
                               delta_db: float = 18.0,
                               tol_hz: float = 5.0) -> np.ndarray:
    """Flag channels likely tracking a cross-correlation of a stronger SV.

    The C/A cross-correlation peaks sit at Doppler offsets that are
    multiples of 1 kHz from the true signal, ~21.6 dB down; the reference
    screens measurements whose Doppler aliases onto a much stronger
    channel's before the LSQ (objects/pvt.cpp:864 error screen).

    Returns [C] bool, True = suspect (exclude from the solution).
    """
    c = np.asarray(cn0_dbhz, np.float64)
    d = np.asarray(doppler_hz, np.float64)
    n = len(c)
    suspect = np.zeros(n, bool)
    for j in range(n):
        for i in range(n):
            if i == j or c[i] - c[j] < delta_db:
                continue
            off = (d[j] - d[i]) % 1000.0
            if min(off, 1000.0 - off) < tol_hz:
                suspect[j] = True
    return suspect


def least_square_pos_raim(sat_pos: np.ndarray, obs: np.ndarray,
                          use_tropo: bool = True, iterations: int = 7,
                          max_residual_m: float = 50.0,
                          max_reject: int = 2) -> LsqSolution:
    """LSQ with residual screening: while the worst post-fit residual
    exceeds max_residual_m and >4 satellites remain, drop the worst and
    re-solve (the reference's converged/residual error screens,
    objects/pvt.cpp:1061-1202). LsqSolution.residuals is [S] over the
    ORIGINAL satellite set; excluded entries hold their last residual,
    and `used` marks what contributed to the fix.
    """
    S = sat_pos.shape[0]
    used = np.ones(S, bool)
    rejected = 0
    while True:
        sol = least_square_pos(sat_pos[used], obs[used],
                               use_tropo=use_tropo, iterations=iterations)
        if not sol.ok:
            sol.used = used
            return sol
        worst = int(np.argmax(np.abs(sol.residuals)))
        if (np.abs(sol.residuals[worst]) <= max_residual_m
                or used.sum() <= 5 or rejected >= max_reject):
            break
        idx = np.nonzero(used)[0][worst]
        used[idx] = False
        rejected += 1
    full_res = np.zeros(S)
    full_res[used] = sol.residuals
    el = np.zeros(S)
    az = np.zeros(S)
    el[used], az[used] = sol.el, sol.az
    out = LsqSolution(sol.pos, el, az, sol.dop, full_res,
                      ok=np.abs(sol.residuals).max(initial=0.0)
                      <= max_residual_m)
    out.used = used
    return out


@dataclasses.dataclass
class NavSolutions:
    """Per-epoch navigation solutions (the navSolutions struct,
    postNavigation.sci:154-280)."""

    t_ms: np.ndarray          # [E] epoch time in stream ms
    x: np.ndarray             # [E] ECEF
    y: np.ndarray
    z: np.ndarray
    dt: np.ndarray            # [E] receiver clock bias [m]
    latitude: np.ndarray      # [E] deg
    longitude: np.ndarray     # [E] deg
    height: np.ndarray        # [E] m
    utm_e: np.ndarray
    utm_n: np.ndarray
    utm_u: np.ndarray
    dop: np.ndarray           # [E, 5]
    n_sats: np.ndarray        # [E]
    valid: np.ndarray         # [E] bool
    # Doppler velocity solution (zeros unless carr_freq was provided).
    vx: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    vy: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    vz: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    ddt: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    vel_valid: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, bool))
    # Cumulative clock-steering applied to transmit time [s] (0 unless
    # nav.clock_steering).
    steer_s: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    # Per-epoch raw measurements (only when navigate(collect_meas=True);
    # feeds the live EKF): list of dicts with t_ms, prns, sat_pos [S,3],
    # obs [S] (satellite-clock-corrected pseudoranges), and — when
    # carr_freq was provided — sat_vel [S,3] and prr [S] m/s.
    meas: list = dataclasses.field(default_factory=list)


def navigate(abs_sample: np.ndarray, prns: Sequence[int],
             subframe_start_ms: Sequence[int], tow_s: float,
             ephs: Dict[int, Ephemeris], sig: SignalConfig,
             nav: NavConfig, n_ms: int,
             carr_freq: Optional[np.ndarray] = None,
             carrier_hz: Optional[np.ndarray] = None,
             satpos_fn=None, satvel_fn=None,
             collect_meas: bool = False,
             carr_cycles: Optional[np.ndarray] = None,
             iono=None,
             smooth_state: Optional[dict] = None) -> NavSolutions:
    """Epoch loop: pseudoranges -> satpos -> LSQ (postNavigation.sci:154+).

    abs_sample: [C, n_ms] from TrackResults (channels in `prns` order).
    subframe_start_ms: per-channel index (in CODE PERIODS) of the decoded
    frame anchor (GPS: first subframe start; GLONASS: time-mark start;
    BeiDou: first subframe start; Galileo: page boundary).
    tow_s: satellite time at that anchor (same for all channels by the
    constellation's common timescale; per-channel anchors decoded at
    different frame positions must be pre-aligned to a common epoch, see
    runtime.receiver).
    carr_freq: optional [C, n_ms] tracked absolute carrier frequency; when
    given, a per-epoch Doppler velocity + clock-drift LSQ is solved too.
    carrier_hz: [C] nominal carrier per channel (FDMA); defaults to
    sig carrier for every channel.
    satpos_fn(t, ephs_list) -> (pos [S,3] m, clk [S] s): constellation
    orbit propagator; defaults to the GPS Kepler satpos
    (GPS/L1/geoFunctions/satpos.sci). GLONASS passes the PZ-90 RK4
    integrator (satposg.sci), BeiDou the CGCS2000 Kepler variant.
    satvel_fn(t, ephs_list) -> (pos, vel, clk): used by the velocity LSQ;
    defaults to the central-difference Kepler propagator.
    """
    C = len(prns)
    if satpos_fn is None:
        satpos_fn = satpos
    if satvel_fn is None:
        from gnsstpu_torch.nav.ekf import satpos_vel
        satvel_fn = satpos_vel
    period_s = sig.code_period_s
    sf = np.asarray(subframe_start_ms, np.int64)
    have_eph = np.array([p in ephs and ephs[p].valid for p in prns])
    sat_elev = np.full(C, np.inf)
    spc = sig.samples_per_code
    # Solution-period step in record indices (code periods): sol_period_ms
    # stays in milliseconds; for 1 ms codes this is 1:1.
    step = max(1, int(round(nav.sol_period_ms * 1e-3 / period_s)))
    n_epochs = int((n_ms - sf.max()) // step)
    E = n_epochs
    out = NavSolutions(
        t_ms=np.zeros(E), x=np.zeros(E), y=np.zeros(E), z=np.zeros(E),
        dt=np.zeros(E), latitude=np.zeros(E), longitude=np.zeros(E),
        height=np.zeros(E), utm_e=np.zeros(E), utm_n=np.zeros(E),
        utm_u=np.zeros(E), dop=np.zeros((E, 5)), n_sats=np.zeros(E, int),
        valid=np.zeros(E, bool),
        vx=np.zeros(E), vy=np.zeros(E), vz=np.zeros(E), ddt=np.zeros(E),
        vel_valid=np.zeros(E, bool), steer_s=np.zeros(E),
    )
    # Per-channel carrier frequency (FDMA channels differ) and the FDMA
    # IF offset the tracking loop folds into carr_freq. TrackResults'
    # carr_freq absorbs each channel's FDMA offset from the zero channel
    # (tracking/driver.py; manager._alloc if_offsets), so Doppler must be
    # recovered as carr_freq - if_freq - fdma_offset per channel.
    fdma_offset = np.zeros(C, np.float64)
    if carr_freq is not None or carr_cycles is not None:
        from gnsstpu_torch.signals.registry import get_signal
        sd = get_signal(sig.signal)
        if carrier_hz is None:
            carrier_hz = np.array([sd.carrier_freq(p) for p in prns],
                                  np.float64)
        else:
            carrier_hz = np.asarray(carrier_hz, np.float64)
        if sd.fdma_zero_prn is not None:
            fdma_offset = (carrier_hz
                           - sd.carrier_freq(sd.fdma_zero_prn))
    steer_total = 0.0
    utm_zone: Optional[int] = None
    # Carrier-derived filter state, keyed by PRN (channel order varies
    # between calls). A live caller (OnlineNavigator) passes a
    # persistent smooth_state dict so the filters survive its rolling
    # solve window; state advances only for latches NEWER than the
    # stored one (re-walked overlap epochs are deduped downstream).
    #   phase: prn -> (t_ms, cycles, abs_sample)
    #   hatch: prn -> [smoothed ABSOLUTE travel-range m, cycles, t_ms,
    #                  count, abs_sample]. Smoothing runs on the
    #     un-rebased travel (abs_sample/spc - epoch) * c*T because the
    #     per-epoch pseudorange rebase floor can jump by whole code
    #     periods between epochs — common-mode for the solve, poison
    #     for a recursive filter.
    if smooth_state is None:
        smooth_state = {}
    prev_phase: Dict[int, tuple] = smooth_state.setdefault("phase", {})
    cs_state: Dict[int, list] = smooth_state.setdefault("hatch", {})
    cs_n = (max(1, int(round(nav.carrier_smoothing_s * 1e3
                             / nav.sol_period_ms)))
            if nav.carrier_smoothing_s > 0 else 0)
    for k in range(n_epochs):
        # Closed-form transmit time: advances with k REGARDLESS of
        # skipped/failed epochs (a single RAIM rejection must not leave
        # every later satpos evaluated at a stale time; the reference
        # advances transmitTime every epoch, postNavigation.sci).
        transmit_time = tow_s + k * step * period_s
        active = np.nonzero(have_eph & (sat_elev >= nav.elevation_mask_deg)
                            )[0]
        out.t_ms[k] = (sf.max() + k * step) * period_s * 1e3
        out.n_sats[k] = len(active)
        if len(active) < 4:
            continue
        ms_meas = sf + k * step
        raw_p = calculate_pseudoranges(
            abs_sample[active], ms_meas[active], spc, nav.start_offset_ms,
            code_period_s=period_s)
        sat_p, sat_clk = satpos_fn(transmit_time,
                                   [ephs[prns[c]] for c in active])
        obs_vec = raw_p + sat_clk * SPEED_OF_LIGHT
        if carr_cycles is not None and cs_n > 1:
            # Hatch carrier smoothing: propagate last epoch's smoothed
            # range by the carrier-phase delta (exact NCO mirror,
            # tracking.carrier), blend in 1/N of the new code range.
            cT = SPEED_OF_LIGHT * period_s
            t_now = float(out.t_ms[k])
            for j, c in enumerate(active):
                ci = int(c)
                prn_c = int(prns[ci])
                # Travel only: abs_sample counts elapsed stream time +
                # travel; subtract the transmit epoch index.
                a_now = float(abs_sample[c, ms_meas[c]])
                p_abs = (a_now / spc - ms_meas[c]) * cT
                phi = float(carr_cycles[c, ms_meas[c]])
                st = cs_state.get(prn_c)
                if st is not None and a_now <= st[4]:
                    continue   # re-walked overlap epoch: leave raw
                if st is not None:
                    # The NCO integrated over the ACTUAL receive-time
                    # span between latches (nominal epoch spacing is
                    # off by the code-Doppler factor — biased at
                    # nonzero IF).
                    dt = (a_now - st[4]) / sig.fs
                    lam_c = SPEED_OF_LIGHT / carrier_hz[ci]
                    dpred = -lam_c * (phi - st[1]
                                      - (sig.if_freq
                                         + fdma_offset[ci]) * dt)
                    if abs((st[0] + dpred) - p_abs) > 300.0:
                        # Carrier stream restarted (re-acquisition) or
                        # slipped: reseed rather than poison the blend.
                        st = None
                    else:
                        cnt = min(st[3] + 1, cs_n)
                        pbar = (p_abs / cnt
                                + (cnt - 1) / cnt * (st[0] + dpred))
                if st is None:
                    pbar, cnt = p_abs, 1
                cs_state[prn_c] = [pbar, phi, t_now, cnt, a_now]
                obs_vec[j] += pbar - p_abs
        sol = least_square_pos_raim(sat_p, obs_vec,
                                    use_tropo=nav.use_tropo,
                                    iterations=nav.lsq_iterations)
        if not sol.ok:
            continue
        if iono is not None:
            # Broadcast Klobuchar correction (the reference only
            # DECODES the alpha/beta page, objects/ephemeris.cpp:314;
            # applying it is a strict improvement): delays evaluated at
            # the first solve's geometry, pseudoranges corrected, one
            # re-solve.
            from gnsstpu_torch.nav import iono as iono_mod
            lat_i, lon_i, _ = geodesy.cart2geo(*sol.pos[:3], 5)
            d = iono_mod.klobuchar_delay(iono, lat_i, lon_i, sol.az,
                                         sol.el, transmit_time)
            if sol.used is not None:
                # RAIM-excluded satellites have zero-filled el/az —
                # no correction for them (they are re-screened anyway).
                d = np.where(sol.used, d, 0.0)
            sol2 = least_square_pos_raim(
                sat_p, obs_vec - d * SPEED_OF_LIGHT,
                use_tropo=nav.use_tropo,
                iterations=nav.lsq_iterations)
            if sol2.ok:
                obs_vec = obs_vec - d * SPEED_OF_LIGHT
                sol = sol2
        prev_elev = sat_elev
        sat_elev = np.full(C, -np.inf)
        sat_elev[active] = np.where(sol.used, sol.el,
                                    prev_elev[active])
        out.x[k], out.y[k], out.z[k], out.dt[k] = sol.pos
        out.dop[k] = sol.dop
        lat, lon, h = geodesy.cart2geo(*sol.pos[:3], 5)
        out.latitude[k], out.longitude[k], out.height[k] = lat, lon, h
        if utm_zone is None:
            utm_zone = geodesy.find_utm_zone(lat, lon)
        out.utm_e[k], out.utm_n[k], out.utm_u[k] = geodesy.cart2utm(
            *sol.pos[:3], utm_zone)
        out.valid[k] = True
        meas_rec = None
        if collect_meas:
            meas_rec = {
                "t_ms": float(out.t_ms[k]),
                "prns": [prns[c] for c in active[sol.used]],
                "sat_pos": sat_p[sol.used],
                "obs": obs_vec[sol.used],
            }
            if carr_cycles is not None:
                # Integrated carrier phase latched at the measurement
                # epoch (the reference's Measurement_M carrier_phase /
                # cycle count, objects/correlator.cpp:263-357
                # TakeMeasurements) plus the phase-rate derived from
                # consecutive latches — a lower-noise range rate than
                # instantaneous Doppler (same -lambda sign convention
                # as prr; NaN until a channel has two latches).
                use_idx = active[sol.used]
                phi = np.array([carr_cycles[c, ms_meas[c]]
                                for c in use_idx])
                lam_u = SPEED_OF_LIGHT / carrier_hz[use_idx]
                prr_ph = np.full(len(use_idx), np.nan)
                for j, c in enumerate(use_idx):
                    prn_c = int(prns[int(c)])
                    a_now = float(abs_sample[c, ms_meas[c]])
                    pv = prev_phase.get(prn_c)
                    if pv is not None and a_now <= pv[2]:
                        continue   # re-walked overlap epoch
                    if pv is not None:
                        # Actual receive-time latch interval (nominal
                        # dt is off by code Doppler; biased at IF!=0).
                        dtp = (a_now - pv[2]) / sig.fs
                        # The NCO integrates IF + FDMA offset + Doppler;
                        # only the Doppler part is range rate.
                        f_phase = ((phi[j] - pv[1]) / dtp
                                   - sig.if_freq - fdma_offset[c])
                        prr_ph[j] = -lam_u[j] * f_phase
                    prev_phase[prn_c] = (float(out.t_ms[k]),
                                         float(phi[j]), a_now)
                meas_rec["carr_phase"] = phi
                meas_rec["prr_phase"] = prr_ph
            out.meas.append(meas_rec)
        if carr_freq is not None and sol.used is not None and sol.used.sum() >= 4:
            use_idx = active[sol.used]
            _, sv_vel, _ = satvel_fn(
                transmit_time, [ephs[prns[c]] for c in use_idx])
            # Average the tracked carrier over a short trailing window:
            # Doppler is near-constant over 100 ms but the per-ms loop
            # output carries PLL jitter.
            w = min(100, step)
            dop_hz = np.array([
                carr_freq[c, max(0, ms_meas[c] - w):ms_meas[c] + 1].mean()
                for c in use_idx]) - sig.if_freq - fdma_offset[use_idx]
            lam = SPEED_OF_LIGHT / carrier_hz[use_idx]
            if meas_rec is not None:
                # Measured range-rate = -lambda * Doppler (closing
                # Doppler positive) — the EKF's prr convention.
                meas_rec["sat_vel"] = sv_vel
                meas_rec["prr"] = -lam * dop_hz
            vsol = least_square_vel(sat_p[sol.used], sv_vel, sol.pos[:3],
                                    dop_hz, lam)
            if vsol.ok:
                out.vx[k], out.vy[k], out.vz[k] = vsol.vel
                out.ddt[k] = vsol.ddt
                out.vel_valid[k] = True
        dt_epoch = step * period_s
        if nav.clock_steering and out.vel_valid[k]:
            # pvt.cpp:379 ClockUpdate analogue — steers the RECEIVER time
            # estimate, not the transmit-time advance: epochs here are
            # indexed by transmitted code periods (ms_meas counts code
            # starts), so advancing transmit_time by sol_period_ms is
            # already exact satellite time regardless of oscillator drift.
            # steer_s records the cumulative receiver-clock rate correction
            # a live receiver would apply to its epoch timestamps.
            steer_total += -dt_epoch * out.ddt[k] / SPEED_OF_LIGHT
        out.steer_s[k] = steer_total
    return out
