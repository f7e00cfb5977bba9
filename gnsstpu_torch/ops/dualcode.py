"""Fused dual-code (pilot + data) E/P/L correlator block op (port of
gnsstpu/ops/dualcode.py).

GLONASS L3OC tracks two ranging codes per satellite, pilot code(prn) and
data code(prn + 32), against the same baseband signal: 12 accumulators per
code period (I/Q x E/P/L for each code). One carrier wipeoff is shared by
both components and the six code rows go through one batched
[C, 6, blk] x [C, blk, 2] product. Both codes share one code NCO (they are
chip-synchronous on the satellite), so the phase state is a plain
CorrState. This exact gather op is the arbiter for kernel K3 and the body
of the 'dual' scan engine.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gnsstpu_torch.device import U32_MASK, f32
from gnsstpu_torch.ops import nco
from gnsstpu_torch.ops.correlate import (CorrState, _accumulate,
                                         _block_geometry, _carr_step,
                                         _window)


class DualBlockOut(NamedTuple):
    """Pilot (ie..ql) + data (ie2..ql2) accumulators for one block, [C]
    each."""

    ie: torch.Tensor
    qe: torch.Tensor
    ip: torch.Tensor
    qp: torch.Tensor
    il: torch.Tensor
    ql: torch.Tensor
    ie2: torch.Tensor
    qe2: torch.Tensor
    ip2: torch.Tensor
    qp2: torch.Tensor
    il2: torch.Tensor
    ql2: torch.Tensor
    blksize: torch.Tensor
    rem_code_phase: torch.Tensor


def correlate_block_dual(chunk: torch.Tensor, padded_code: torch.Tensor,
                         padded_code2: torch.Tensor,
                         base_carr_step_u32: torch.Tensor,
                         state: CorrState, *, blkmax: int, spacing: float,
                         code_length: int, base_code_step: float,
                         inv_fs: float):
    """Correlate one code period of both components for C channels.

    Args as ops.correlate.correlate_block, plus padded_code2 [C,
    code_length + 2], the data component's padded code. Returns
    (DualBlockOut, new CorrState).
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
    t_p = state.rem_code_phase[:, None] + k[None, :] * step[:, None]
    rows = []
    for code in (padded_code, padded_code2):
        for off in (-spacing, 0.0, spacing):
            idx = torch.floor(t_p + f32(off)).to(torch.int64) + 1
            idx = torch.clamp(idx, 0, code_length + 1)
            rows.append(torch.gather(code, 1, idx).to(torch.float32))
    acc = _accumulate(torch.stack(rows, dim=1), bb_i, bb_q, mask)  # [C,6,2]

    new_rem = (state.rem_code_phase + blksize.to(torch.float32) * step
               - f32(code_length))
    new_carr = (state.carr_phase_u32
                + blksize.to(torch.int64) * carr_step) & U32_MASK
    out = DualBlockOut(
        *(acc[:, j, iq] for j in range(6) for iq in (0, 1)),
        blksize=blksize, rem_code_phase=new_rem)
    new_state = state._replace(
        rem_code_phase=new_rem, carr_phase_u32=new_carr,
        sample_pos=state.sample_pos + blksize)
    return out, new_state
