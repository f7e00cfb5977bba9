"""Fused BOC double-estimator correlator block op for Galileo E1 (port of
gnsstpu/ops/boc.py).

One call processes one 4 ms E1B code period for all C channels: carrier
wipeoff, independent fractional-phase sampling of the primary code (E/P/L)
and of the BOC(1,1) subcarrier ("meandr", E/P/L), and the ten accumulators
I/Q x {E_P, P_E, P_P, P_L, L_P} of the double-estimator tracker
(subscript order (meandr, code): I_E_P = early meandr x prompt code). The
reference vmaps a per-channel op; here the channel axis leads every
tensor, and the ten accumulators are one batched [C, 5, blk] x [C, blk, 2]
product.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gnsstpu_torch.device import U32_MASK, f32
from gnsstpu_torch.ops import nco
from gnsstpu_torch.ops.correlate import _accumulate, _carr_step, _window


class BocCorrState(NamedTuple):
    """Per-channel double-estimator phase state, [C] tensors."""

    rem_code_phase: torch.Tensor   # f32, primary chips
    rem_sub_phase: torch.Tensor    # f32, meandr half-chips
    carr_phase_u32: torch.Tensor   # int64 holding u32 carrier NCO phase
    sample_pos: torch.Tensor       # i32, next unread sample
    code_delta: torch.Tensor       # f32, codeFreq - code basis [Hz]
    sub_delta: torch.Tensor        # f32, meandrFreq - sub basis [Hz]
    carr_delta: torch.Tensor       # f32, carrFreq - IF [Hz]


class BocBlockOut(NamedTuple):
    """Ten accumulators (first subscript = meandr delay, second = code
    delay) + block bookkeeping, [C] each."""

    i_ep: torch.Tensor
    q_ep: torch.Tensor
    i_pe: torch.Tensor
    q_pe: torch.Tensor
    i_pp: torch.Tensor
    q_pp: torch.Tensor
    i_pl: torch.Tensor
    q_pl: torch.Tensor
    i_lp: torch.Tensor
    q_lp: torch.Tensor
    blksize: torch.Tensor
    rem_code_phase: torch.Tensor
    rem_sub_phase: torch.Tensor


def correlate_block_boc(chunk: torch.Tensor, padded_code: torch.Tensor,
                        padded_sub: torch.Tensor,
                        base_carr_step_u32: torch.Tensor,
                        state: BocCorrState, *, blkmax: int,
                        code_spacing: float, sub_spacing: float,
                        code_length: int, sub_length: int,
                        base_code_step: float, base_sub_step: float,
                        inv_fs: float):
    """Correlate one code period with split code/subcarrier estimators.

    chunk: f32 [N, 2]; padded_code: [C, code_length + 2] primary codes
    (+-1), index floor(t) + 1; padded_sub: [sub_length + 2] meandr;
    base_carr_step_u32: [C] int64 u32 steps. code_spacing is the DLL
    early-late offset [primary chips], sub_spacing the SLL offset [meandr
    half-chips]. Returns (BocBlockOut, new BocCorrState).
    """
    step_c = f32(base_code_step) + state.code_delta * f32(inv_fs)
    step_s = f32(base_sub_step) + state.sub_delta * f32(inv_fs)
    blksize_f = torch.ceil((f32(code_length) - state.rem_code_phase)
                           / step_c)
    blksize = torch.clamp(blksize_f.to(torch.int32), 1, blkmax)

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
    t_c = state.rem_code_phase[:, None] + k[None, :] * step_c[:, None]
    t_s = state.rem_sub_phase[:, None] + k[None, :] * step_s[:, None]
    sub = padded_sub[None, :].expand(t_s.shape[0], -1)

    def taps(t, off, padded, length):
        idx = torch.floor(t + f32(off)).to(torch.int64) + 1
        idx = torch.clamp(idx, 0, length + 1)
        return torch.gather(padded, 1, idx).to(torch.float32)

    code_e = taps(t_c, -code_spacing, padded_code, code_length)
    code_p = taps(t_c, 0.0, padded_code, code_length)
    code_l = taps(t_c, code_spacing, padded_code, code_length)
    sub_e = taps(t_s, -sub_spacing, sub, sub_length)
    sub_p = taps(t_s, 0.0, sub, sub_length)
    sub_l = taps(t_s, sub_spacing, sub, sub_length)
    tap_mat = torch.stack([
        sub_e * code_p,    # E_P  (SLL early)
        sub_p * code_e,    # P_E  (DLL early)
        sub_p * code_p,    # P_P
        sub_p * code_l,    # P_L  (DLL late)
        sub_l * code_p,    # L_P  (SLL late)
    ], dim=1)                                              # [C, 5, blkmax]
    acc = _accumulate(tap_mat, bb_i, bb_q, mask)           # [C, 5, 2]

    bsf = blksize.to(torch.float32)
    new_rem_c = state.rem_code_phase + bsf * step_c - f32(code_length)
    new_rem_s = state.rem_sub_phase + bsf * step_s - f32(sub_length)
    new_carr = (state.carr_phase_u32
                + blksize.to(torch.int64) * carr_step) & U32_MASK
    out = BocBlockOut(
        i_ep=acc[:, 0, 0], q_ep=acc[:, 0, 1],
        i_pe=acc[:, 1, 0], q_pe=acc[:, 1, 1],
        i_pp=acc[:, 2, 0], q_pp=acc[:, 2, 1],
        i_pl=acc[:, 3, 0], q_pl=acc[:, 3, 1],
        i_lp=acc[:, 4, 0], q_lp=acc[:, 4, 1],
        blksize=blksize, rem_code_phase=new_rem_c,
        rem_sub_phase=new_rem_s)
    new_state = state._replace(
        rem_code_phase=new_rem_c, rem_sub_phase=new_rem_s,
        carr_phase_u32=new_carr, sample_pos=state.sample_pos + blksize)
    return out, new_state
