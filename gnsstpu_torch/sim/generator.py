"""Multi-satellite IF signal generator (port of gnsstpu/sim/generator.py).

Long-horizon phase bookkeeping (carrier cycles, absolute chip count) is
done on the host in float64 at 1 ms block granularity, exactly as the
reference does; the device then synthesizes every block from float32
local ramps and adds complex Gaussian noise drawn from a torch.Generator
seeded by (seed, ms0). The noise therefore differs from the reference's
jax.random bits for the same seed; the noise-free signal is the same.
With noise="jax" the noise is the reference's own draw,
jax.random.normal(fold_in(PRNGKey(seed), ms0)) for I and its fold_in(.., 1)
for Q, made by sim.jaxrand on the device without JAX: a reference test's
signal is then made again to the last bits of float32 erfinv.

Truth signal per satellite (complex IF):
    s(t) = A * d(t - tau) * c(t - tau) * exp(+i*(2*pi*(f_if + fd)*t
             + pi*fd_rate*t^2 + phi0)),
with the code rate scaled by the carrier Doppler (code/carrier coherence).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from gnsstpu_torch.config import SignalConfig
from gnsstpu_torch.signals.registry import get_signal
from gnsstpu_torch.device import f32, resolve_device


@dataclasses.dataclass
class SatParams:
    """Truth parameters for one simulated satellite."""

    prn: int
    doppler_hz: float = 0.0          # carrier Doppler at t=0
    doppler_rate: float = 0.0        # [Hz/s]
    # FDMA carrier offset from cfg.if_freq [Hz] (does not scale the code
    # rate). GLONASS: k * L1_IF_step.
    if_offset_hz: float = 0.0
    code_phase_chips: float = 0.0    # initial code delay tau in chips (>=0)
    carrier_phase: float = 0.0       # [rad]
    cn0_dbhz: float = 45.0           # carrier-to-noise density (vs sigma=1)
    nav_bits: Optional[np.ndarray] = None  # +-1 bits, one per bit period


class IFSimulator:
    """Block-based IF sample generator on `device` (the card by default;
    a CUDA request on a host without one raises)."""

    def __init__(self, cfg: SignalConfig, sats: Sequence[SatParams],
                 noise_sigma: float = 1.0, seed: int = 0, *,
                 device="cuda", noise: str = "torch"):
        if noise not in ("torch", "jax"):
            raise ValueError(f"noise must be 'torch' or 'jax', not {noise!r}")
        self.noise = noise
        self.cfg = cfg
        self.sats = list(sats)
        self.noise_sigma = float(noise_sigma)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.sd = get_signal(cfg.signal)
        bs = cfg.fs * 1e-3
        if abs(bs - round(bs)) > 1e-9:
            raise ValueError("fs must be an integer multiple of 1 kHz")
        self.block_samples = int(round(bs))
        # C/N0 = A^2 fs / sigma^2 for complex noise of variance sigma^2.
        self._amps = np.array(
            [np.sqrt(10 ** (s.cn0_dbhz / 10) / cfg.fs) * noise_sigma
             for s in self.sats], np.float64).astype(np.float32)
        self._codes = np.stack([self.sd.code_fn(s.prn)
                                for s in self.sats]).astype(np.float32)
        maxbits = max((len(s.nav_bits) if s.nav_bits is not None else 1)
                      for s in self.sats)
        bits = np.ones((len(self.sats), maxbits), np.float32)
        for i, s in enumerate(self.sats):
            if s.nav_bits is not None:
                b = np.asarray(s.nav_bits, np.float32)
                bits[i, :len(b)] = b
                if len(b) < maxbits:
                    bits[i, len(b):] = np.resize(b, maxbits - len(b))
        self._bits = bits

    def _block_params(self, ms0: int, n_ms: int) -> dict:
        """Per (sv, block) start phases in float64 on the host (same
        arithmetic as the reference); returns [S, n_ms] arrays."""
        cfg, sd = self.cfg, self.sd
        t_b = (ms0 + np.arange(n_ms, dtype=np.float64)) * 1e-3
        S = len(self.sats)
        carr_frac = np.empty((S, n_ms))
        fc_cyc = np.empty((S, n_ms))
        rate_cyc = np.empty((S, n_ms))
        chip_in_per = np.empty((S, n_ms))
        per_count = np.empty((S, n_ms), np.int64)
        dchip = np.empty((S, n_ms))
        for i, s in enumerate(self.sats):
            f_carr = sd.carrier_freq(s.prn)
            f_if = cfg.if_freq + s.if_offset_hz
            fd_t = s.doppler_hz + s.doppler_rate * t_b
            phase_cyc = ((f_if + s.doppler_hz) * t_b
                         + 0.5 * s.doppler_rate * t_b ** 2
                         + s.carrier_phase / (2 * np.pi))
            carr_frac[i] = np.mod(phase_cyc, 1.0)
            fc_cyc[i] = (f_if + fd_t) / cfg.fs
            rate_cyc[i] = s.doppler_rate / (cfg.fs * cfg.fs)
            code_scale = 1.0 + (s.doppler_hz + 0.5 * s.doppler_rate * t_b) \
                / f_carr
            chips = cfg.code_freq * t_b * code_scale - s.code_phase_chips
            per = np.floor(chips / cfg.code_length)
            per_count[i] = per.astype(np.int64)
            chip_in_per[i] = chips - per * cfg.code_length
            dchip[i] = cfg.code_freq * (1.0 + fd_t / f_carr) / cfg.fs
        return {"carr_frac": carr_frac.astype(np.float32),
                "fc_cyc": fc_cyc.astype(np.float32),
                "rate_cyc": rate_cyc.astype(np.float32),
                "chip_in_per": chip_in_per.astype(np.float32),
                "per_count": per_count.astype(np.int32),
                "dchip": dchip.astype(np.float32)}

    def generate_tensor(self, n_ms: int, ms0: int = 0) -> torch.Tensor:
        """n_ms milliseconds from ms0 as f32 [n_ms*fs/1e3, 2] on device."""
        dev = self.device
        L = self.cfg.code_length
        bit_len = self.sd.bit_len_codes
        p = {k: torch.as_tensor(v, device=dev)
             for k, v in self._block_params(ms0, n_ms).items()}
        k = torch.arange(self.block_samples, dtype=torch.float32,
                         device=dev)[None, :]
        two_pi = f32(2.0 * np.pi)
        si = torch.zeros((n_ms, self.block_samples), device=dev)
        sq = torch.zeros_like(si)
        for i in range(len(self.sats)):
            code = torch.as_tensor(self._codes[i], device=dev)
            bvec = torch.as_tensor(self._bits[i], device=dev)
            cf, fc, rc, cip, pc, dc = (
                p[n][i][:, None] for n in ("carr_frac", "fc_cyc", "rate_cyc",
                                           "chip_in_per", "per_count",
                                           "dchip"))
            ang = two_pi * (cf + k * fc + (k * k) * (0.5 * rc))
            ph = cip + k * dc
            wrap = torch.floor(ph / L).to(torch.int32)
            chip = (ph - wrap.to(torch.float32) * L).to(torch.int64)
            cvals = code[torch.clamp(chip, 0, L - 1)]
            bidx = torch.div(pc + wrap, bit_len, rounding_mode="floor")
            bvals = bvec[torch.clamp(bidx.to(torch.int64), 0,
                                     bvec.shape[0] - 1)]
            env = float(self._amps[i]) * cvals * bvals
            si += env * torch.cos(ang)
            sq += env * torch.sin(ang)
        if self.noise_sigma > 0:
            nsig = self.noise_sigma * f32(np.sqrt(0.5))
            if self.noise == "jax":
                from gnsstpu_torch.sim import jaxrand

                key = jaxrand.fold_in(jaxrand.prng_key(self.seed), int(ms0))
                si += nsig * jaxrand.normal(key, tuple(si.shape), dev)
                sq += nsig * jaxrand.normal(jaxrand.fold_in(key, 1),
                                            tuple(sq.shape), dev)
            else:
                g = torch.Generator(device=dev)
                g.manual_seed(self.seed * 1_000_003 + int(ms0))
                si += nsig * torch.randn(si.shape, generator=g, device=dev)
                sq += nsig * torch.randn(sq.shape, generator=g, device=dev)
        return torch.stack([si.reshape(-1), sq.reshape(-1)], dim=-1)

    def generate(self, n_ms: int, ms0: int = 0) -> np.ndarray:
        """n_ms milliseconds from ms0 as host f32 [n_ms*fs/1e3, 2]."""
        return self.generate_tensor(n_ms, ms0).cpu().numpy()
