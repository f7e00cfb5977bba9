"""Integer numerically-controlled oscillators (port of gnsstpu/ops/nco.py).

Carrier phase lives in uint32 "cycles / 2^32" units and advances by an
integer step per sample; the wrap mod 2^32 is the phase wrap. Here the
u32 values ride int64 tensors masked with U32_MASK (see device.py).
Large static frequencies are quantized once on the host in float64
(freq_to_step_u32); only the small loop-filter delta is converted on the
device in float32 (delta_freq_to_step_i32).
"""

from __future__ import annotations

import numpy as np
import torch

from gnsstpu_torch.device import U32_MASK, f32

TWO_PI = 2.0 * np.pi
# Phase LSB in radians: 2*pi / 2^32, as float32 (reference _PHASE_SCALE).
PHASE_SCALE = f32(TWO_PI / 4294967296.0)


def freq_to_step_u32(freq_hz: float, fs: float) -> np.uint32:
    """Host-side exact uint32 NCO step for a static frequency (copied from
    gnsstpu.ops.nco, whose module imports jax)."""
    cycles_per_sample = float(freq_hz) / float(fs) % 1.0
    return np.uint32(np.round(cycles_per_sample * 4294967296.0))


def delta_freq_to_step_i32(delta_hz: torch.Tensor, fs: float
                           ) -> torch.Tensor:
    """Signed NCO step (int64 tensor holding int32 values) for a small f32
    frequency delta: round-half-even of delta * f32(2^32 / fs)."""
    return torch.round(delta_hz * f32(4294967296.0 / fs)).to(torch.int64)


def carrier_ramp_u32(phase_u32: torch.Tensor, step_u32: torch.Tensor,
                     n: int):
    """phase + k*step for k < n with u32 wrap, over any leading shape.

    Returns (phases [..., n], final = phase + n*step [...])."""
    k = torch.arange(n, dtype=torch.int64, device=phase_u32.device)
    phases = (phase_u32[..., None] + k * step_u32[..., None]) & U32_MASK
    final = (phase_u32 + n * step_u32) & U32_MASK
    return phases, final


def phase_u32_to_angle(phase_u32: torch.Tensor) -> torch.Tensor:
    """u32 phase -> radians in [0, 2*pi) as float32."""
    return phase_u32.to(torch.float32) * PHASE_SCALE


def lo_iq(phase_u32: torch.Tensor):
    """(cos, sin) local-oscillator planes from integer phase."""
    ang = phase_u32_to_angle(phase_u32)
    return torch.cos(ang), torch.sin(ang)


def lo_angles_factored(phase_u32: torch.Tensor, step_u32: torch.Tensor,
                       n: int, b: int = 64):
    """Coarse and fine angles of the factored ramp k = a*b + r (k < n):
    coarse[..., a] = angle(phase + a*(b*step)), fine[..., r] =
    angle(r*step), both from wrapped u32 phase."""
    dev = phase_u32.device
    a_n = -(-n // b)
    ia = torch.arange(a_n, dtype=torch.int64, device=dev)
    ir = torch.arange(b, dtype=torch.int64, device=dev)
    bstep = (b * step_u32) & U32_MASK
    ka = (phase_u32[..., None] + ia * bstep[..., None]) & U32_MASK
    kr = (ir * step_u32[..., None]) & U32_MASK
    return phase_u32_to_angle(ka), phase_u32_to_angle(kr)


def lo_iq_factored(phase_u32: torch.Tensor, step_u32: torch.Tensor,
                   n: int, b: int = 64):
    """(cos, sin) of phase + k*step, k < n, by the angle-sum factorization

        e^{i(phi + k s)} = e^{i(phi + a(bs))} * e^{i(r s)},  k = a*b + r,

    which needs 2*(ceil(n/b) + b) transcendentals instead of 2*n. The
    fused tracking kernel (K1) uses the same factorization, so the scan
    engine's table mode and the kernel see the same LO waveform.

    Returns (lo_cos [..., n], lo_sin [..., n]) f32.
    """
    aa, ar = lo_angles_factored(phase_u32, step_u32, n, b)
    ca, sa = torch.cos(aa), torch.sin(aa)
    cr, sr = torch.cos(ar), torch.sin(ar)
    lo_c = ca[..., :, None] * cr[..., None, :] - sa[..., :, None] * sr[
        ..., None, :]
    lo_s = sa[..., :, None] * cr[..., None, :] + ca[..., :, None] * sr[
        ..., None, :]
    lead = lo_c.shape[:-2]
    return (lo_c.reshape(*lead, -1)[..., :n],
            lo_s.reshape(*lead, -1)[..., :n])
