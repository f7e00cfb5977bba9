"""Batched FFT correlation acquisition (port of gnsstpu/ops/fft_acquire.py).

The whole (PRN x Doppler x code-phase) power cube is one batch of
torch.fft transforms over complex64 (cuFFT on the card). The reference's
split-complex Stockham/matmul FFTs and its PRN chunking existed because
the TPU has no complex dtype (gnsstpu/ops/fftsc.py) and are not ported.
Correlation is zero-padded linear correlation to the next power of two:
each window carries one extra code period of real samples, so lags
[0, samples_per_code) are exact for any sample rate.

The numpy grid/table helpers are copied from the reference module, which
imports jax.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gnsstpu_torch.ops import code_tables
from gnsstpu_torch.device import f32


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def doppler_grid(if_freq: float, band_hz: float, step_hz: float
                 ) -> np.ndarray:
    """Carrier-frequency search grid [D]."""
    n = round(band_hz / step_hz) + 1
    return if_freq - band_hz / 2 + step_hz * np.arange(n)


def window_len(samples_per_code: int, coh_periods: int) -> int:
    """Samples per coherent window incl. the extra code period of tail."""
    return (coh_periods + 1) * samples_per_code


def code_fd_table(signal: str, fs: float, code_freq: float,
                  code_length: int, coh_periods: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """conj(FFT(code tiled over the coherent window, zero-padded)) for all
    PRNs: (re, im) f32 [P, Npad]."""
    table = code_tables.sampled_code_table(signal, fs, code_freq,
                                           code_length)
    spc = table.shape[1]
    L = coh_periods * spc
    npad = next_pow2(L + spc)
    tiled = np.zeros((table.shape[0], npad), np.float32)
    tiled[:, :L] = np.tile(table.astype(np.float32), (1, coh_periods))
    fd = np.conj(np.fft.fft(tiled, axis=1))
    return fd.real.astype(np.float32), fd.imag.astype(np.float32)


#: Largest [B, D, c, Npad] complex64 spectrum product per PRN chunk.
_CHUNK_BYTES = 512 << 20


def acquire_cube(blocks_iq, code_fd: Optional[torch.Tensor],
                 doppler_hz: Optional[torch.Tensor], fs: float,
                 samples_per_code: int, *, combine: str = "max"
                 ) -> torch.Tensor:
    """Correlation power cube over (PRN, Doppler, code phase).

    blocks_iq: f32 [B, Lw, 2] coherent windows (window_len samples each);
    code_fd: complex64 [P, Npad] conj code spectra (code_fd_table);
    doppler_hz: f32 [D] absolute carrier frequencies to wipe off;
    combine: 'max' over windows (bit-flip dodge) or 'sum' (noncoherent).
    PRNs go through the inverse FFTs in chunks of as many PRNs as fit a
    [B, D, c, Npad] spectrum product under _CHUNK_BYTES, at least one
    (as the reference maps over PRN chunks): a Galileo E1B search at 4.2
    Msps holds 127 MB per PRN at 121 Doppler bins. An FDMA search is one
    code row (P = 1) and is not split: at GLONASS L1OF 8.192 Msps its
    798 carriers x 2 windows x 32,768 points give f, the product and the
    inverse transform 418 MB each, and the search takes 1,871.9 MB beyond
    what was allocated before it (chip_smoke.py's phase 16 on an NVIDIA
    H100 80GB HBM3 at 700 W).

    Sharded: blocks_iq is the AcqShards bundle of
    parallel.shard_acquisition_inputs (code_fd and doppler_hz None). Each
    cell computes its PRN x Doppler sub-cube on its device and the cube
    is assembled on the mesh's first device.
    Returns f32 [P, D, samples_per_code].
    """
    if code_fd is None:
        return _sharded_cube(blocks_iq, fs, samples_per_code, combine)
    B, Lw, _ = blocks_iq.shape
    P, npad = code_fd.shape
    dev = blocks_iq.device
    t = torch.arange(Lw, dtype=torch.float32, device=dev) * f32(1.0 / fs)
    ang = (f32(2.0 * np.pi) * doppler_hz)[:, None] * t[None, :]   # [D, Lw]
    lo_c, lo_s = torch.cos(ang), torch.sin(ang)
    xr = blocks_iq[:, None, :, 0]                               # [B, 1, Lw]
    xi = blocks_iq[:, None, :, 1]
    w = torch.complex(xr * lo_c + xi * lo_s, xi * lo_c - xr * lo_s)
    f = torch.fft.fft(w, n=npad, dim=-1)                        # [B, D, Np]
    per_prn = B * f.shape[1] * npad * 8
    step = max(1, min(P, _CHUNK_BYTES // per_prn))
    parts = []
    for p0 in range(0, P, step):
        prod = f[:, :, None, :] * code_fd[None, None, p0:p0 + step]
        corr = torch.fft.ifft(prod, dim=-1)[..., :samples_per_code]
        power = corr.real * corr.real + corr.imag * corr.imag  # [B,D,c,S]
        parts.append(power.sum(0) if combine == "sum" else power.amax(0))
    return torch.cat(parts, dim=1).permute(1, 0, 2).contiguous()  # [P,D,S]


def _sharded_cube(shards, fs: float, samples_per_code: int,
                  combine: str) -> torch.Tensor:
    """acquire_cube over an AcqShards bundle: [P, D, S] on the mesh's
    first device."""
    first = shards.mesh.first_device
    n_p, n_d = shards.shape
    rows = []
    for i in range(n_p):
        cols = []
        for j in range(n_d):
            _, blocks, code_fd, dopp = shards.cells[(i, j)]
            cols.append(acquire_cube(blocks, code_fd, dopp, fs,
                                     samples_per_code, combine=combine
                                     ).to(first))
        rows.append(torch.cat(cols, dim=1))
    return torch.cat(rows, dim=0)


def peak_metrics(cube: torch.Tensor, *, samples_per_code: int,
                 samples_per_chip: int) -> dict:
    """Peak / second-peak detection per PRN: the second peak is the
    largest value of the best Doppler row outside +-1 chip (circularly) of
    the main peak. Returns [P] tensors metric, code_phase, doppler_bin,
    peak."""
    c = cube[:, :, :samples_per_code]
    row_peak = c.amax(dim=2)                                   # [P, D]
    best_bin = torch.argmax(row_peak, dim=1)                   # [P]
    best_row = torch.take_along_dim(c, best_bin[:, None, None],
                                    dim=1)[:, 0, :]            # [P, S]
    code_phase = torch.argmax(best_row, dim=1)
    peak = best_row.amax(dim=1)
    s = torch.arange(samples_per_code, device=cube.device)
    dist = torch.abs(s[None, :] - code_phase[:, None])
    dist = torch.minimum(dist, samples_per_code - dist)
    masked = torch.where(dist > samples_per_chip, best_row,
                         torch.full_like(best_row, -float("inf")))
    second = masked.amax(dim=1)
    return {"metric": peak / torch.clamp(second, min=1e-30),
            "code_phase": code_phase, "doppler_bin": best_bin,
            "peak": peak}
