"""Lock detectors and C/N0 estimation from prompt correlator streams
(port of gnsstpu/tracking/lock.py: the numpy host path is copied, since
that package's __init__ imports jax; assess_device is torch).

Host-side (NumPy) per-epoch statistics, the framework's equivalent of the
reference's lock machinery:
  * C/N0 narrowband/wideband power ratio estimator — reference
    Channel::EstCN0 (objects/channel.cpp:322) and the Scilab receivers'
    implicit C/N0 proxies;
  * PLL lock: mean(I^2 - Q^2) / mean(I^2 + Q^2) (NBD/NBP), the classic
    Costas lock indicator — plays the role of the ARM firmware's
    power-based CODE/CARR/PHASE lock cascade
    (tests_ARM/namuro_nano_tnkernel.c:596-621 AcqThresh/LossThresh);
  * code lock: prompt power vs early+late power sanity.

These run on [C, n_ms] epoch arrays (one chunk of TrackOut), vectorized
over channels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class LockStatus:
    """Per-channel lock summary over one epoch ([C] arrays)."""

    cn0_dbhz: np.ndarray        # estimated C/N0
    pll_lock: np.ndarray        # NBD/NBP in [-1, 1]; ~1 = phase locked
    code_lock: np.ndarray       # prompt/(early+late) envelope ratio
    locked: np.ndarray          # combined boolean


def cn0_nwpr(i_p: np.ndarray, q_p: np.ndarray, t_int_s: float,
             m: int = 20) -> np.ndarray:
    """Narrowband-wideband power ratio C/N0 estimate.

    i_p/q_p: [C, n] prompt streams at the code-period cadence.
    t_int_s: coherent integration per prompt (code period).
    m: prompts per NWPR group (20 = one GPS nav bit).

    NP = (sum_m I)^2 + (sum_m Q)^2, WP = sum_m (I^2 + Q^2);
    mu = NP/WP; C/N0 = (mu - 1) / (m - mu) / t_int_s.
    The narrowband sum is applied to |I| to stay data-bit invariant
    (equivalent to the reference's dot-product bit wipe).
    """
    C, n = i_p.shape
    g = n // m
    if g == 0:
        raise ValueError(f"need >= {m} prompts")
    ii = np.abs(i_p[:, : g * m].reshape(C, g, m)).sum(axis=2)
    qq = q_p[:, : g * m].reshape(C, g, m).sum(axis=2)
    np_ = ii * ii + qq * qq
    wp = (i_p[:, : g * m].reshape(C, g, m) ** 2
          + q_p[:, : g * m].reshape(C, g, m) ** 2).sum(axis=2)
    mu = np.mean(np_ / np.maximum(wp, 1e-30), axis=1)
    ratio = np.clip((mu - 1.0) / np.maximum(m - mu, 1e-6), 1e-10, None)
    return 10.0 * np.log10(ratio / t_int_s)


def pll_lock_indicator(i_p: np.ndarray, q_p: np.ndarray) -> np.ndarray:
    """Costas lock: mean(I^2 - Q^2)/mean(I^2 + Q^2) per channel."""
    nbd = np.mean(i_p ** 2 - q_p ** 2, axis=1)
    nbp = np.mean(i_p ** 2 + q_p ** 2, axis=1)
    return nbd / np.maximum(nbp, 1e-30)


def code_lock_indicator(i_e, q_e, i_p, q_p, i_l, q_l) -> np.ndarray:
    """Prompt envelope over E+L envelopes (≈1.0/2·(1-spacing) when locked,
    << when the code is drifting)."""
    p = np.mean(np.sqrt(i_p ** 2 + q_p ** 2), axis=1)
    el = np.mean(np.sqrt(i_e ** 2 + q_e ** 2)
                 + np.sqrt(i_l ** 2 + q_l ** 2), axis=1)
    return p / np.maximum(el, 1e-30)


def assess(i_e, q_e, i_p, q_p, i_l, q_l, t_int_s: float,
           cn0_drop_dbhz: float = 30.0, pll_min: float = 0.5,
           m: int = 20) -> LockStatus:
    """Combined per-epoch lock assessment (AcqThresh/LossThresh style)."""
    cn0 = cn0_nwpr(i_p, q_p, t_int_s, m=m)
    pll = pll_lock_indicator(i_p, q_p)
    code = code_lock_indicator(i_e, q_e, i_p, q_p, i_l, q_l)
    locked = (cn0 > cn0_drop_dbhz) & (pll > pll_min)
    return LockStatus(cn0_dbhz=cn0, pll_lock=pll, code_lock=code,
                      locked=locked)


def assess_device(i_e, q_e, i_p, q_p, i_l, q_l, t_int_s: float,
                  cn0_drop_dbhz: float = 30.0, pll_min: float = 0.5,
                  m: int = 20):
    """Device (torch, f32) twin of assess() over [E, C] epoch tensors, so
    lock supervision needs only a [C]-sized readback. Returns a dict of
    [C] tensors {cn0_dbhz, pll_lock, code_lock, locked}."""
    E, C = i_p.shape
    g = E // m
    ip = i_p[: g * m].reshape(g, m, C)
    qp = q_p[: g * m].reshape(g, m, C)
    ii = ip.abs().sum(dim=1)
    qq = qp.sum(dim=1)
    np_ = ii * ii + qq * qq
    wp = (ip * ip + qp * qp).sum(dim=1)
    mu = (np_ / torch.clamp(wp, min=1e-30)).mean(dim=0)          # [C]
    ratio = torch.clamp((mu - 1.0) / torch.clamp(m - mu, min=1e-6),
                        min=1e-10)
    cn0 = 10.0 * torch.log10(ratio / t_int_s)
    nbd = (i_p ** 2 - q_p ** 2).mean(dim=0)
    nbp = (i_p ** 2 + q_p ** 2).mean(dim=0)
    pll = nbd / torch.clamp(nbp, min=1e-30)
    pmean = torch.sqrt(i_p ** 2 + q_p ** 2).mean(dim=0)
    el = (torch.sqrt(i_e ** 2 + q_e ** 2)
          + torch.sqrt(i_l ** 2 + q_l ** 2)).mean(dim=0)
    code = pmean / torch.clamp(el, min=1e-30)
    locked = (cn0 > cn0_drop_dbhz) & (pll > pll_min)
    return {"cn0_dbhz": cn0, "pll_lock": pll, "code_lock": code,
            "locked": locked}
