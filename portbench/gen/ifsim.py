"""Multi-satellite complex IF samples on the device, and the radio's 2-bit
sm2 packing: a frozen copy of the port's sim/generator.py IFSimulator
(torch noise).

The long-horizon phase bookkeeping (carrier cycles, absolute chip count)
is float64 on the host at 1 ms granularity; the device synthesises each
block from float32 local ramps. Truth per stream:
    s(t) = A d(t - tau) c(t - tau) exp(i (2 pi (f_if + fd) t
           + pi fd_rate t^2 + phi0)),
with the code rate scaled by the carrier Doppler. Complex Gaussian noise
of variance sigma^2 comes from a torch.Generator seeded per 1 s piece from
the run's seed, so a recording is the same for the same seed on the same
device.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.gen.sky import Signal, Sky

PIECE_MS = 1000


def _block_params(sig: Signal, sats, ms0: int, n_ms: int) -> dict:
    t_b = (ms0 + np.arange(n_ms, dtype=np.float64)) * 1e-3
    S = len(sats)
    out = {k: np.empty((S, n_ms)) for k in (
        "carr_frac", "fc_cyc", "rate_cyc", "chip_in_per", "dchip")}
    per_count = np.empty((S, n_ms), np.int64)
    for i, s in enumerate(sats):
        f_if = sig.if_freq + s.if_offset_hz
        fd_t = s.doppler_hz + s.doppler_rate * t_b
        phase_cyc = ((f_if + s.doppler_hz) * t_b
                     + 0.5 * s.doppler_rate * t_b ** 2
                     + s.carrier_phase / (2 * np.pi))
        out["carr_frac"][i] = np.mod(phase_cyc, 1.0)
        out["fc_cyc"][i] = (f_if + fd_t) / sig.fs
        out["rate_cyc"][i] = s.doppler_rate / (sig.fs * sig.fs)
        scale = 1.0 + (s.doppler_hz + 0.5 * s.doppler_rate * t_b) \
            / sig.carrier_hz
        chips = sig.code_freq * t_b * scale - s.code_phase_chips
        per = np.floor(chips / sig.code_length)
        per_count[i] = per.astype(np.int64)
        out["chip_in_per"][i] = chips - per * sig.code_length
        out["dchip"][i] = sig.code_freq * (1.0 + fd_t / sig.carrier_hz) \
            / sig.fs
    res = {k: v.astype(np.float32) for k, v in out.items()}
    res["per_count"] = per_count.astype(np.int32)
    return res


class IFSim:
    """Block-based IF generator for one sky on one device."""

    def __init__(self, sky: Sky, noise_sigma: float = 1.0, seed: int = 0,
                 device="cuda"):
        self.sig = sky.signal
        self.sats = list(sky.sats)
        self.noise_sigma = float(noise_sigma)
        self.seed = int(seed)
        self.device = torch.device(device)
        bs = self.sig.fs * 1e-3
        if abs(bs - round(bs)) > 1e-9:
            raise ValueError("fs must be an integer multiple of 1 kHz")
        self.block_samples = int(round(bs))
        self._amps = np.array(
            [np.sqrt(10 ** (s.cn0_dbhz / 10) / self.sig.fs) * noise_sigma
             for s in self.sats], np.float64).astype(np.float32)
        self._codes = np.stack([self.sig.code(s.prn)
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

    def _noise_seed(self, ms0: int) -> int:
        st = np.random.SeedSequence([self.seed, 7, int(ms0)]).generate_state(
            2, np.uint32)
        return int(st[0]) << 31 | int(st[1]) >> 1

    def generate(self, n_ms: int, ms0: int = 0) -> torch.Tensor:
        """n_ms milliseconds from ms0 as f32 [n_ms * fs / 1e3, 2]."""
        dev = self.device
        L = self.sig.code_length
        p = {k: torch.as_tensor(v, device=dev) for k, v in
             _block_params(self.sig, self.sats, ms0, n_ms).items()}
        k = torch.arange(self.block_samples, dtype=torch.float32,
                         device=dev)[None, :]
        two_pi = np.float32(2.0 * np.pi)
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
            bidx = torch.div(pc + wrap, self.sig.bit_len_codes,
                             rounding_mode="floor")
            bvals = bvec[torch.clamp(bidx.to(torch.int64), 0,
                                     bvec.shape[0] - 1)]
            env = float(self._amps[i]) * cvals * bvals
            si += env * torch.cos(ang)
            sq += env * torch.sin(ang)
        if self.noise_sigma > 0:
            nsig = self.noise_sigma * np.float32(np.sqrt(0.5))
            g = torch.Generator(device=dev)
            g.manual_seed(self._noise_seed(ms0))
            si += nsig * torch.randn(si.shape, generator=g, device=dev)
            sq += nsig * torch.randn(sq.shape, generator=g, device=dev)
        return torch.stack([si.reshape(-1), sq.reshape(-1)], dim=-1)


def pack_sm2(x: torch.Tensor) -> torch.Tensor:
    """f32 [N, 2] I/Q (N even) -> sm2 bytes [N / 2] on x's device: per
    sample a nibble of I sign, I magnitude (|x| >= 1), Q sign, Q
    magnitude, the earlier sample in the low nibble."""
    if x.shape[0] % 2:
        raise ValueError("sm2 needs an even sample count")
    sign = (x < 0).to(torch.uint8)
    mag = (x.abs() >= 1.0).to(torch.uint8)
    nib = sign[:, 0] | (mag[:, 0] << 1) | (sign[:, 1] << 2) | (mag[:, 1] << 3)
    return nib[0::2] | (nib[1::2] << 4)


def sm2_levels(packed: torch.Tensor) -> torch.Tensor:
    """sm2 bytes -> f32 [2 N, 2] I/Q levels (+-1, +-3) on packed's
    device: the inverse of pack_sm2 up to its quantization."""
    nib = torch.stack([packed & 0x0F, packed >> 4], dim=1).reshape(-1)
    out = torch.empty((nib.shape[0], 2), dtype=torch.float32,
                      device=packed.device)
    for lane, shift in ((0, 0), (1, 2)):
        sign = ((nib >> shift) & 1).to(torch.float32)
        mag = ((nib >> (shift + 1)) & 1).to(torch.float32)
        out[:, lane] = (1.0 - 2.0 * sign) * (1.0 + 2.0 * mag)
    return out


def recording(sky: Sky, n_ms: int, seed: int, device) -> torch.Tensor:
    """n_ms of the sky's signal in unit noise, packed to sm2 on the
    device 1 s at a time: uint8 [n_ms * fs / 1e3 / 2]."""
    sim = IFSim(sky, noise_sigma=1.0, seed=seed, device=device)
    return torch.cat([pack_sm2(sim.generate(min(PIECE_MS, n_ms - ms0), ms0))
                      for ms0 in range(0, n_ms, PIECE_MS)])
