"""Resampled ranging-code tables.

Equivalent of the reference's makeCaTable
(GPS/L1/include/makeCaTable.sci) and of the realtime receiver's pre-sampled
PRN rows (correlator.cpp SamplePRN) / baked FFT replicas (prn_codes.h):
codes are expanded once on the host to the sampling grid and cached, then
moved to device as a [num_prn, samples_per_code] matrix that acquisition and
tracking kernels reuse.

Copied from gnsstpu/ops/code_tables.py; only the import prefix differs.
"""

from __future__ import annotations

import functools

import numpy as np

from gnsstpu_torch.signals.registry import get_signal


@functools.lru_cache(maxsize=None)
def sampled_code_table(signal: str, fs: float, code_freq: float,
                       code_length: int) -> np.ndarray:
    """All PRN codes sampled at fs over one code period.

    Sample k holds the chip active at instant k/fs: chip index
    floor(k*code_freq/fs). (Same role as the reference's makeCaTable.sci,
    but point-sampled at interval starts rather than its interval-end ceil
    — see gnsstpu.ops.correlate for the convention note.)
    Returns ±1 int8 [num_prn, samples_per_code].
    """
    sd = get_signal(signal)
    spc = round(fs * code_length / code_freq)
    k = np.arange(spc, dtype=np.float64)
    idx = np.floor(k * code_freq / fs).astype(np.int64)
    idx = np.clip(idx, 0, code_length - 1)
    rows = [sd.code_fn(prn)[idx] for prn in range(1, sd.num_prn + 1)]
    return np.stack(rows).astype(np.int8)


@functools.lru_cache(maxsize=None)
def phase_row_table(signal: str, fs: float, code_freq: float,
                    code_length: int, blkmax: int,
                    phases_per_chip: int = 64) -> np.ndarray:
    """Phase-quantized pre-sampled code rows for the fast correlator.

    Row p holds the code point-sampled at the NOMINAL chip rate starting
    from chip phase (-2 + p/phases_per_chip), circularly:

        table[prn, p, k] = code[ floor(-2 + p/PH + k*code_freq/fs) mod L ]

    The tracking kernel then fetches E/P/L as three whole-row dynamic
    lookups instead of per-sample gathers (gathers are the slowest op on
    a TPU; contiguous row reads stream at full HBM/VMEM bandwidth). The
    [-2, 2) phase span covers rem_code_phase in (-1, 1) plus correlator
    spacing. This is the makeCaTable idea (GPS/L1/include/makeCaTable.sci)
    taken to its TPU-native conclusion. Returns int8 [num_prn, 4*PH, blkmax].
    """
    sd = get_signal(signal)
    ph = phases_per_chip
    rows = 4 * ph
    s = float(code_freq) / float(fs)
    k = np.arange(blkmax, dtype=np.float64)
    p = np.arange(rows, dtype=np.float64)
    idx = np.floor(-2.0 + p[:, None] / ph + k[None, :] * s).astype(np.int64)
    idx %= code_length                                   # [rows, blkmax]
    out = np.empty((sd.num_prn, rows, blkmax), np.int8)
    for prn in range(1, sd.num_prn + 1):
        out[prn - 1] = sd.code_fn(prn)[idx]
    return out


@functools.lru_cache(maxsize=None)
def prompt_row_table(signal: str, fs: float, code_freq: float,
                     code_length: int, blkmax: int,
                     phases_per_chip: int = 64,
                     span_chips: float = 0.75) -> np.ndarray:
    """Prompt-only phase-row table for the fused Pallas kernel, float32.

    Row p = code point-sampled at the nominal rate from chip phase
    (-span_chips + p/phases_per_chip); rem_code_phase stays within
    (-step, step] so [-0.75, 0.75) covers it with margin. The fused
    kernel derives EARLY/LATE by rolling the prompt row by +-d samples
    (d = round(spacing * fs / code_freq)), so no E/L rows are stored —
    1/3 the memory of phase_row_table, in f32 because the TPU compiler
    only supports dynamic sublane slicing of f32 rows.

    Returns f32 [num_prn, R, blkmax], R = 2 * span * phases_per_chip.
    """
    sd = get_signal(signal)
    ph = phases_per_chip
    rows = int(round(2 * span_chips * ph))
    s = float(code_freq) / float(fs)
    k = np.arange(blkmax, dtype=np.float64)
    p = np.arange(rows, dtype=np.float64)
    idx = np.floor(-span_chips + p[:, None] / ph
                   + k[None, :] * s).astype(np.int64)
    idx %= code_length
    out = np.empty((sd.num_prn, rows, blkmax), np.float32)
    for prn in range(1, sd.num_prn + 1):
        out[prn - 1] = sd.code_fn(prn)[idx]
    return out


@functools.lru_cache(maxsize=None)
def padded_code_table(signal: str) -> np.ndarray:
    """Codes padded by one chip on each side for early/late indexing.

    padded[0] = last chip, padded[1:L+1] = code, padded[L+1] = first chip —
    matches the reference's caCode = [caCode($) caCode caCode(1)]
    (tracking.sci:142). Chip phase t (chips, in (-1, L+spacing)) maps to
    index ceil(t) + 1. Returns ±1 int8 [num_prn, code_length + 2].
    """
    sd = get_signal(signal)
    out = np.empty((sd.num_prn, sd.code_length + 2), dtype=np.int8)
    for prn in range(1, sd.num_prn + 1):
        c = sd.code_fn(prn)
        out[prn - 1, 0] = c[-1]
        out[prn - 1, 1:-1] = c
        out[prn - 1, -1] = c[0]
    return out
