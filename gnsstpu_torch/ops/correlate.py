"""Early/prompt/late correlator block op (port of gnsstpu/ops/correlate.py).

One call processes one code period (~1 ms) for all C channels at once:
carrier wipeoff from the integer NCO, E/P/L code sampling, and the six
accumulator dot products. The reference vmaps a per-channel op; here the
channel axis is written out as the leading dimension of every tensor.

Fixed-size sample blocks (`blkmax`) carry a validity mask for the
data-dependent block length ceil((L - rem)/step), as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gnsstpu_torch.device import U32_MASK, f32
from gnsstpu_torch.ops import nco


class CorrState(NamedTuple):
    """Per-channel correlator phase state, [C] tensors."""

    rem_code_phase: torch.Tensor   # f32, chips in (-1, 1)
    carr_phase_u32: torch.Tensor   # int64 holding u32 carrier NCO phase
    sample_pos: torch.Tensor       # i32, next unread sample (chunk-relative)
    code_delta: torch.Tensor       # f32, codeFreq - code_freq_basis [Hz]
    carr_delta: torch.Tensor       # f32, carrFreq - if_freq [Hz]


class BlockOut(NamedTuple):
    """Per-block correlator outputs, [C] each."""

    ie: torch.Tensor
    qe: torch.Tensor
    ip: torch.Tensor
    qp: torch.Tensor
    il: torch.Tensor
    ql: torch.Tensor
    blksize: torch.Tensor          # i32 samples consumed
    rem_code_phase: torch.Tensor   # f32 remainder after this block


def _block_geometry(state: CorrState, *, code_length: int,
                    base_code_step: float, inv_fs: float, blkmax: int):
    step = f32(base_code_step) + state.code_delta * f32(inv_fs)
    blksize_f = torch.ceil((f32(code_length) - state.rem_code_phase) / step)
    blksize = torch.clamp(blksize_f.to(torch.int32), 1, blkmax)
    return step, blksize


def _window(chunk: torch.Tensor, sample_pos: torch.Tensor, blkmax: int):
    """[C, blkmax, 2] windows at each channel's cursor, as
    jax.lax.dynamic_slice takes them: a negative start counts from the
    end of the chunk, then a start past N - blkmax is clamped. (A cursor
    that drifts to -1 within a serial superepoch thus reads the chunk's
    tail for one block, as the reference's scan engines do.)"""
    n = chunk.shape[0]
    start = sample_pos.to(torch.int64)
    start = torch.clamp(torch.where(start < 0, start + n, start), 0,
                        n - blkmax)
    idx = start[:, None] + torch.arange(blkmax, device=chunk.device)
    return chunk[idx]


def _carr_step(base_carr_step_u32, carr_delta, inv_fs: float):
    return (base_carr_step_u32
            + nco.delta_freq_to_step_i32(carr_delta, 1.0 / inv_fs)
            ) & U32_MASK


def _accumulate(code_mat, bb_i, bb_q, mask):
    """code_mat [C, 3, blk] x [C, blk, 2] -> [C, 3, 2] (one batched GEMM,
    the reference's [3, blk] x [blk, 2] matmul per channel)."""
    bb = torch.stack([bb_i * mask, bb_q * mask], dim=-1)
    return torch.bmm(code_mat, bb)


def _finish(state: CorrState, acc, blksize, step, carr_step,
            code_length: int):
    new_rem = (state.rem_code_phase + blksize.to(torch.float32) * step
               - f32(code_length))
    new_carr = (state.carr_phase_u32
                + blksize.to(torch.int64) * carr_step) & U32_MASK
    out = BlockOut(
        ie=acc[:, 0, 0], qe=acc[:, 0, 1],
        ip=acc[:, 1, 0], qp=acc[:, 1, 1],
        il=acc[:, 2, 0], ql=acc[:, 2, 1],
        blksize=blksize, rem_code_phase=new_rem)
    new_state = state._replace(
        rem_code_phase=new_rem, carr_phase_u32=new_carr,
        sample_pos=state.sample_pos + blksize)
    return out, new_state


def correlate_block(chunk: torch.Tensor, padded_code: torch.Tensor,
                    base_carr_step_u32: torch.Tensor, state: CorrState, *,
                    blkmax: int, spacing: float, code_length: int,
                    base_code_step: float, inv_fs: float):
    """Exact per-sample correlation of one code period for C channels.

    chunk: f32 [N, 2] IF samples shared by all channels; padded_code:
    [C, code_length + 2] (code_tables.padded_code_table rows);
    base_carr_step_u32: [C] int64 u32 carrier steps.
    Returns (BlockOut, new CorrState); the loop-filter deltas are left to
    the tracking layer.
    """
    step, blksize = _block_geometry(
        state, code_length=code_length, base_code_step=base_code_step,
        inv_fs=inv_fs, blkmax=blkmax)
    window = _window(chunk, state.sample_pos, blkmax)
    carr_step = _carr_step(base_carr_step_u32, state.carr_delta, inv_fs)
    phases, _ = nco.carrier_ramp_u32(state.carr_phase_u32, carr_step,
                                     blkmax)
    lo_re, lo_im = nco.lo_iq(phases)
    x_re, x_im = window[..., 0], window[..., 1]
    bb_i = x_re * lo_re + x_im * lo_im
    bb_q = x_im * lo_re - x_re * lo_im

    dev = chunk.device
    k = torch.arange(blkmax, dtype=torch.float32, device=dev)
    mask = (torch.arange(blkmax, device=dev)[None, :]
            < blksize[:, None]).to(torch.float32)
    # E/P/L chip indices floor(t + off) + 1 into the padded code (point
    # sampling at the start of each sample interval, as the reference).
    # t = rem + k * step rounded once, as the reference's XLA program
    # computes it on the CPU (a fused multiply-add; the f64 product of two
    # f32 values is exact): a second rounding moves a sample that lies on
    # a chip edge into the next chip.
    t_p = (state.rem_code_phase.double()[:, None]
           + k.double()[None, :] * step.double()[:, None]).float()
    codes = []
    for off in (-spacing, 0.0, spacing):
        idx = torch.floor(t_p + f32(off)).to(torch.int64) + 1
        idx = torch.clamp(idx, 0, code_length + 1)
        codes.append(torch.gather(padded_code, 1, idx).to(torch.float32))
    acc = _accumulate(torch.stack(codes, dim=1), bb_i, bb_q, mask)
    return _finish(state, acc, blksize, step, carr_step, code_length)


def correlate_block_fast(chunk: torch.Tensor, code_rows: torch.Tensor,
                         base_carr_step_u32: torch.Tensor,
                         state: CorrState, *, blkmax: int, spacing: float,
                         code_length: int, base_code_step: float,
                         inv_fs: float, phases_per_chip: int = 64):
    """Phase-table variant: factored LO (nco.lo_iq_factored) and E/P/L as
    whole pre-sampled rows of the 1/phases_per_chip phase table
    (code_tables.phase_row_table, rows over chip phase [-2, 2)).

    code_rows: [C, 4*phases_per_chip, blkmax].
    """
    step, blksize = _block_geometry(
        state, code_length=code_length, base_code_step=base_code_step,
        inv_fs=inv_fs, blkmax=blkmax)
    window = _window(chunk, state.sample_pos, blkmax)
    carr_step = _carr_step(base_carr_step_u32, state.carr_delta, inv_fs)
    lo_re, lo_im = nco.lo_iq_factored(state.carr_phase_u32, carr_step,
                                      blkmax)
    x_re, x_im = window[..., 0], window[..., 1]
    bb_i = x_re * lo_re + x_im * lo_im
    bb_q = x_im * lo_re - x_re * lo_im

    dev = chunk.device
    mask = (torch.arange(blkmax, device=dev)[None, :]
            < blksize[:, None]).to(torch.float32)
    ph = f32(phases_per_chip)
    rows = 4 * phases_per_chip
    ch = torch.arange(code_rows.shape[0], device=dev)
    codes = []
    for off in (-spacing, 0.0, spacing):
        p = torch.round((state.rem_code_phase + f32(off) + 2.0) * ph)
        p = torch.clamp(p.to(torch.int64), 0, rows - 1)
        codes.append(code_rows[ch, p].to(torch.float32))
    acc = _accumulate(torch.stack(codes, dim=1), bb_i, bb_q, mask)
    return _finish(state, acc, blksize, step, carr_step, code_length)
