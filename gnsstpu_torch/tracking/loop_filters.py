"""Tracking-loop filter coefficients (copied from
gnsstpu/tracking/loop_filters.py: that package's __init__ imports jax).

Same design points as the reference:
  * 2nd-order DLL from noise bandwidth + damping
    (GPS/L1/include/calcLoopCoef.sci),
  * FLL-assisted PLL gains from the Kaplan "Understanding GPS" table 5.6
    constants (GPS/L1/include/calcFLLPLLLoopCoef.sci:1-8).
"""

from __future__ import annotations


def dll_coeffs(bw_hz: float, damping: float, gain: float = 1.0):
    """(tau1, tau2) for the 2nd-order code loop filter."""
    wn = bw_hz * 8.0 * damping / (4.0 * damping**2 + 1.0)
    tau1 = gain / (wn * wn)
    tau2 = 2.0 * damping / wn
    return tau1, tau2


def fll_pll_coeffs(pll_bw_hz: float, fll_bw_hz: float, t_int: float):
    """(k1, k2, k3) for the FLL-assisted PLL NCO update
    carr_nco += k1*phase_err - k2*old_phase_err - k3*freq_err."""
    k1 = t_int * (pll_bw_hz / 0.53) ** 2 + 1.414 * (pll_bw_hz / 0.53)
    k2 = 1.414 * (pll_bw_hz / 0.53)
    k3 = t_int * (fll_bw_hz / 0.25)
    return k1, k2, k3
