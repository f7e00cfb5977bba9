"""Extended Kalman filter navigation: position/velocity/clock states.

The reference carries an EKF navigation state alongside the epoch LSQ —
the realtime receiver streams it to the ground station (gse/src/gui_ekf
display; EKF telemetry message in includes/messages.h:37-64) and the
MATLAB analysis scripts plot it (matlab/analyze_ekf.m). This module is
that component rebuilt: an 8-state PV+clock EKF over pseudorange and
pseudorange-rate (carrier-Doppler) measurements, with the same
measurement screens the reference applies before its LSQ (residual
rejection, pvt.cpp:811,864,1061).

State x = [p(3) m, v(3) m/s, b m (clock bias*c), bd m/s (drift*c)].
Host-side float64 NumPy, like the LSQ layer; the filter is tiny and
branchy — exactly the part of the receiver that stays off-device.

Copied from gnsstpu/nav/ekf.py; only the import prefix differs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from gnsstpu_torch.config import SPEED_OF_LIGHT
from gnsstpu_torch.nav import geodesy
from gnsstpu_torch.nav.orbits import satpos
from gnsstpu_torch.nav.types import Ephemeris


def satpos_vel(transmit_time, ephs: Sequence[Ephemeris],
               dt: float = 0.5):
    """(pos [S,3], vel [S,3], clk [S]) — central-difference velocity of
    the Kepler propagator (orbits.central_diff_vel)."""
    from gnsstpu_torch.nav.orbits import central_diff_vel

    return central_diff_vel(satpos, transmit_time, ephs, dt)


@dataclasses.dataclass
class EkfConfig:
    sigma_pr: float = 5.0        # pseudorange noise [m]
    sigma_prr: float = 0.2      # pseudorange-rate noise [m/s]
    q_accel: float = 1.0        # velocity random walk PSD [m^2/s^3]
    q_clk_bias: float = 1e-1    # clock phase PSD (h0-like) [m^2/s]
    q_clk_drift: float = 1e-2   # clock freq PSD (h-2-like) [m^2/s^3]
    gate_sigma: float = 5.0     # innovation gate, in sigmas
    use_tropo: bool = True


@dataclasses.dataclass
class EkfStep:
    accepted: np.ndarray   # [S] bool per pseudorange
    innovations: np.ndarray  # [S] pre-fit residuals [m]
    pos: np.ndarray        # [3]
    vel: np.ndarray        # [3]
    clock_bias_m: float
    clock_drift_ms: float


class NavEkf:
    """8-state navigation EKF.

    Usage: seed from an LSQ fix (x0=[pos, 0, bias, 0]) then call
    step(dt, sat_pos, pr[, sat_vel, prr]) once per measurement epoch.
    """

    N = 8

    def __init__(self, x0: np.ndarray, cfg: EkfConfig = EkfConfig(),
                 p0_pos: float = 100.0, p0_vel: float = 10.0,
                 p0_clk: float = 1000.0, p0_drift: float = 100.0):
        self.cfg = cfg
        self.x = np.asarray(x0, np.float64).copy()
        assert self.x.shape == (self.N,)
        self.P = np.diag([p0_pos ** 2] * 3 + [p0_vel ** 2] * 3
                         + [p0_clk ** 2, p0_drift ** 2]).astype(np.float64)

    # -- model ------------------------------------------------------------
    def _predict(self, dt: float) -> None:
        F = np.eye(self.N)
        F[0:3, 3:6] = dt * np.eye(3)
        F[6, 7] = dt
        c = self.cfg
        Q = np.zeros((self.N, self.N))
        # white-accel PV block (per axis)
        q = c.q_accel
        Q[0:3, 0:3] = np.eye(3) * q * dt ** 3 / 3.0
        Q[0:3, 3:6] = np.eye(3) * q * dt ** 2 / 2.0
        Q[3:6, 0:3] = Q[0:3, 3:6]
        Q[3:6, 3:6] = np.eye(3) * q * dt
        # two-state clock
        Q[6, 6] = c.q_clk_bias * dt + c.q_clk_drift * dt ** 3 / 3.0
        Q[6, 7] = c.q_clk_drift * dt ** 2 / 2.0
        Q[7, 6] = Q[6, 7]
        Q[7, 7] = c.q_clk_drift * dt
        self.x = F @ self.x
        self.P = F @ self.P @ F.T + Q

    def _scalar_update(self, z: float, h: float, H: np.ndarray,
                       r: float) -> tuple:
        """Sequential scalar measurement update with sigma gating;
        returns (accepted, innovation)."""
        y = z - h
        s = float(H @ self.P @ H + r)
        if y * y > (self.cfg.gate_sigma ** 2) * s:
            return False, y
        k = (self.P @ H) / s
        self.x = self.x + k * y
        ikh = np.eye(self.N) - np.outer(k, H)
        self.P = ikh @ self.P @ ikh.T + r * np.outer(k, k)
        return True, y

    # -- public -----------------------------------------------------------
    def step(self, dt: float, sat_pos: np.ndarray, pr: np.ndarray,
             sat_vel: Optional[np.ndarray] = None,
             prr: Optional[np.ndarray] = None) -> EkfStep:
        """Predict dt seconds, then fuse S pseudoranges (and optionally
        pseudorange rates, positive = increasing range).

        sat_pos [S,3] ECEF at transmit time; pr [S] satellite-clock
        corrected pseudoranges [m]. Sagnac and tropo corrections are
        applied here from the current state estimate.
        """
        if dt > 0:
            self._predict(dt)
        S = len(pr)

        def geom(i):
            """(predicted range+tropo, unit LOS) from the CURRENT state —
            sequential scalar updates must re-linearize after each
            accepted measurement, or large initial errors leave stale
            residuals behind."""
            p = self.x[0:3]
            rho = np.linalg.norm(sat_pos[i] - p)
            rot = geodesy.e_r_corr(
                np.array([rho / SPEED_OF_LIGHT]), sat_pos[i][None])[0]
            los = rot - p
            rng = np.linalg.norm(los)
            u_i = los / rng
            if self.cfg.use_tropo:
                _, el, _ = geodesy.topocent(p, los[None])
                rng += float(geodesy.tropo(np.sin(np.radians(el)))[0])
            return rng, u_i

        accepted = np.zeros(S, bool)
        innov = np.zeros(S)
        # Order by the CHEAP geometric range residual (full Sagnac/tropo
        # geometry is evaluated once per measurement, inside the loop,
        # after earlier accepted updates re-linearize the state).
        pred0 = np.linalg.norm(sat_pos - self.x[0:3], axis=1)
        order = np.argsort(np.abs(pr - (pred0 + self.x[6])))
        u = np.zeros((S, 3))
        for i in order:
            rng, u[i] = geom(i)
            H = np.zeros(self.N)
            H[0:3] = -u[i]
            H[6] = 1.0
            accepted[i], innov[i] = self._scalar_update(
                pr[i], rng + self.x[6], H, self.cfg.sigma_pr ** 2)
        if prr is not None and sat_vel is not None:
            for i in range(S):
                if not accepted[i]:
                    continue
                H = np.zeros(self.N)
                H[3:6] = -u[i]
                H[7] = 1.0
                h = float(u[i] @ (sat_vel[i] - self.x[3:6])) + self.x[7]
                self._scalar_update(prr[i], h, H,
                                    self.cfg.sigma_prr ** 2)
        return EkfStep(accepted=accepted, innovations=innov,
                       pos=self.x[0:3].copy(), vel=self.x[3:6].copy(),
                       clock_bias_m=float(self.x[6]),
                       clock_drift_ms=float(self.x[7]))
