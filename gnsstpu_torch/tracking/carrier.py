"""Integrated carrier-phase reconstruction (TakeMeasurements role).

Copied from gnsstpu/tracking/carrier.py, whose package __init__ imports
jax; the host mirror is numpy either way.

The reference latches accumulated carrier phase + cycle counts per
measurement epoch through a delayed buffer for carrier-phase work
(objects/correlator.cpp:263-357 TakeMeasurements, `Measurement_M` in
includes/structs.h: carrier_nco, carrier_phase, cycles mod 2^32). The
TPU framework's correlators keep the exact same state — a uint32
carrier NCO stepped by round(f_carr * 2^32 / fs) per sample
(ops/nco.py, ops/correlate.py:112-147) — but reading it back per block
would add a readback lane. Instead the HOST mirrors the integer NCO
exactly from observables it already receives each superepoch:

  * the per-block carrier Doppler stream is the POST-block filtered
    delta (tracking/scan.py one_block), so block b integrates with the
    delta output at block b-1 (the acquisition handoff Doppler before
    the first block);
  * the per-block blksize stream gives the integer sample count;
  * the slot's carr_base uint32 step covers IF + FDMA offset.

acc = sum_b blksize_b * (carr_base + round_f32(delta_{b-1} * 2^32/fs))
reproduces the device's uint32 NCO phase bit-exactly (mod 2^32 — the
accumulator additionally keeps the unbounded cycle count the u32 state
wraps away). Integrated carrier phase in cycles is acc / 2^32.
"""

from __future__ import annotations

import numpy as np

_U32 = 4294967296.0


def nco_steps_i64(deltas_hz: np.ndarray, fs: float) -> np.ndarray:
    """Mirror ops.nco.delta_freq_to_step_i32's f32 rounding on host."""
    scale = np.float32(_U32 / fs)
    return np.round(np.asarray(deltas_hz, np.float32) * scale).astype(
        np.int64)


class CarrierPhaseAccumulator:
    """Per-channel integrated carrier phase from the Doppler/blksize
    observable streams — exact mirror of the correlator's uint32 NCO,
    extended to an unbounded integer cycle count (Python int)."""

    def __init__(self, carr_base_u32: int, fs: float,
                 doppler0_hz: float):
        self.base = int(carr_base_u32)
        self.fs = float(fs)
        self.acc = 0                 # exact: sum of blk * step_u32
        self.last_delta = float(doppler0_hz)

    def update(self, dopp_hz: np.ndarray,
               blksize: np.ndarray) -> np.ndarray:
        """Advance over one epoch's blocks; returns f64 cumulative
        carrier phase [cycles since channel start] at each block END."""
        dopp_hz = np.asarray(dopp_hz, np.float32)
        blk = np.asarray(blksize, np.float64).astype(np.int64)
        prev = np.empty(len(dopp_hz), np.float32)
        prev[0] = self.last_delta
        prev[1:] = dopp_hz[:-1]
        steps = self.base + nco_steps_i64(prev, self.fs)
        cum = np.cumsum(blk * steps)          # < 2^63 per epoch
        out = (np.float64(self.acc) + cum.astype(np.float64)) / _U32
        self.acc += int(cum[-1])
        self.last_delta = float(dopp_hz[-1])
        return out

    @property
    def cycles(self) -> float:
        """Total integrated carrier phase [cycles] since channel start."""
        return float(self.acc / _U32)

    @property
    def phase_u32(self) -> int:
        """The device correlator's uint32 NCO phase this accumulator
        predicts (bit-exact parity check vs state.corr.carr_phase_u32)."""
        return self.acc & 0xFFFFFFFF
