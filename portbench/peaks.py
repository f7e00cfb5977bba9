"""The card's published peaks and the tracking kernels' least work per
launch: the yardstick of the roofline shares.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit: HBM
3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores.

A launch of the live receiver's kernel tracks every one of the bank's C
channels over the n_blocks code periods of one supervision epoch
(n_blocks = epoch_ms / code period). Its least work, counted once: the
epoch's samples (f32 I/Q, 8 bytes each) read once, at least one tap row
per channel (int8, blkp = samples per code + 2 bytes, tap_planes of
them), the state read and written once (state_lanes f32 lanes per
channel) and the outputs written once (out_lanes f32 lanes per channel
and block); and per sample each
channel covers, the kernel's float32 operations. Each kernel's counts
are data, in kernels/<name>.json (K1: 18 operations a sample, one tap
plane; K3: 24 and six, the counts of the port's chip_smoke.py bounds).
"""

from __future__ import annotations

HBM_BPS = 3.35e12
F32_FLOPS = 67e12


def launch_work(kernel: dict, cfg: dict) -> tuple:
    """(bytes, flops) of one launch of a kernel (its kernels/<name>.json)
    under a configuration."""
    s = cfg["signal"]
    spc = round(s["fs"] * s["code_length"] / s["code_freq"])
    C = int(cfg["manager"]["n_channels"])
    n_blocks = int(cfg["manager"]["epoch_ms"] // s["code_period_ms"])
    samples = n_blocks * spc
    n_bytes = (samples * 8 + C * int(kernel["tap_planes"]) * (spc + 2)
               + 2 * C * int(kernel["state_lanes"]) * 4
               + n_blocks * C * int(kernel["out_lanes"]) * 4)
    return float(n_bytes), float(kernel["flops_per_sample"]) * C * samples


def bound_s(n_bytes: float, flops: float) -> float:
    """Least seconds the card could take for this work."""
    return max(n_bytes / HBM_BPS, flops / F32_FLOPS)
