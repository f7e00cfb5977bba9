"""Aperiodic-code tracking: GLONASS P ("VT") code closed loop (port of
gnsstpu/tracking/pcode.py).

The GLONASS P code is 5,110,000 chips at 5.11 Mcps, one full second per
period (signals.glonass.generate_p_code; reference
GLONASS/L2/include/generatePcode.sci:14-22). The tracker keeps an
ABSOLUTE chip offset as extra state and walks the code array block by
block: each 1 ms block correlates against chips [chip_off,
chip_off + 5110) gathered from the code span on the device, with the
scan engine's DLL / FLL-assisted PLL (tracking.sci:291-335 semantics).

The reference's lax.scan becomes a loop over blocks of plain torch ops
on the tensors' device (one channel: GLONASS P is one code). The u32
carrier NCO rides int64 masked with 0xFFFFFFFF, as in tracking.scan. It
has no Pallas kernel in the reference and so no hand kernel here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gnsstpu_torch.config import TrackConfig
from gnsstpu_torch.device import U32_MASK, f32, resolve_device
from gnsstpu_torch.ops import nco
from gnsstpu_torch.tracking import loop_filters

P_CODE_FREQ = 5.11e6
BLOCK_CHIPS = 5110             # chips per 1 ms block


class PState(NamedTuple):
    rem: torch.Tensor            # f32 chips into the current block
    chip_off: torch.Tensor       # i32 absolute chip index of block start
    carr_phase_u32: torch.Tensor  # int64 holding the u32 carrier phase
    sample_pos: torch.Tensor     # i32 next unread sample
    code_delta: torch.Tensor     # f32 codeFreq - 5.11e6 [Hz]
    carr_delta: torch.Tensor     # f32 carrFreq - IF [Hz]
    doppler_basis: torch.Tensor
    carr_nco: torch.Tensor
    old_carr_err: torch.Tensor
    code_nco: torch.Tensor
    old_code_err: torch.Tensor
    ip_prev: torch.Tensor
    qp_prev: torch.Tensor

    @staticmethod
    def init(sample_pos: int, chip_off: int, doppler_hz: float,
             aid_div: float, *, device="cuda") -> "PState":
        """Scalar state on `device` ('cuda', the default; or 'cpu')."""
        dev = resolve_device(device)

        def t(v, dtype=torch.float32):
            return torch.tensor(v, dtype=dtype, device=dev)

        dp = t(np.float32(doppler_hz))
        z = t(0.0)
        return PState(
            rem=z, chip_off=t(chip_off, torch.int32),
            carr_phase_u32=t(0, torch.int64),
            sample_pos=t(sample_pos, torch.int32),
            code_delta=dp / t(np.float32(aid_div)), carr_delta=dp,
            doppler_basis=dp, carr_nco=z, old_carr_err=z, code_nco=z,
            old_code_err=z, ip_prev=t(1e-3), qp_prev=t(1e-3))


def make_pcode_tracker(fs: float, if_freq: float, trk: TrackConfig, *,
                       n_blocks: int, aid_div: float):
    """Build track(chunk [N, 2] f32, code +-1 f32 [n_chips], state) ->
    (state, outs dict of [n_blocks] tensors). aid_div = f_carrier /
    5.11e6 (carrier aiding divisor for this frequency channel)."""
    blkmax = int(np.ceil(fs * 1e-3)) + 2
    base_step = f32(np.float64(P_CODE_FREQ) / fs)
    base_carr = int(nco.freq_to_step_u32(if_freq, fs))
    tau1, tau2 = loop_filters.dll_coeffs(trk.dll_bw, trk.dll_damping, 1.0)
    k1, k2, k3 = loop_filters.fll_pll_coeffs(trk.pll_bw, trk.fll_bw,
                                             trk.pdi)
    c_dll_p, c_dll_i = f32(tau2 / tau1), f32(trk.pdi / tau1)
    k1, k2, k3 = f32(k1), f32(k2), f32(k3)
    inv_aid = f32(1.0 / aid_div)
    inv_fs = f32(1.0 / fs)
    inv_pi = f32(1.0 / np.pi)
    inv_2pi = f32(1.0 / (2.0 * np.pi))
    offs = (-float(trk.el_spacing), 0.0, float(trk.el_spacing))

    def one_block(chunk, code, st: PState):
        dev = chunk.device
        step = base_step + st.code_delta * inv_fs
        blkf = torch.ceil((f32(BLOCK_CHIPS) - st.rem) / step)
        blk = torch.clamp(blkf.to(torch.int32), 1, blkmax)

        # The window as jax.lax.dynamic_slice takes it (ops.correlate).
        n = chunk.shape[0]
        start = st.sample_pos.to(torch.int64)
        start = torch.clamp(torch.where(start < 0, start + n, start), 0,
                            n - blkmax)
        ki = torch.arange(blkmax, device=dev)
        window = chunk[start + ki]
        carr_step = (base_carr + nco.delta_freq_to_step_i32(
            st.carr_delta, fs)) & U32_MASK
        ang = nco.phase_u32_to_angle((st.carr_phase_u32 + ki * carr_step)
                                     & U32_MASK)
        lo_c, lo_s = torch.cos(ang), torch.sin(ang)
        xr, xi = window[:, 0], window[:, 1]
        bb_i = xr * lo_c + xi * lo_s
        bb_q = xi * lo_c - xr * lo_s

        mask = (ki < blk).to(torch.float32)
        # One rounding of rem + k * step, as the reference's fused XLA
        # program takes it (ops.correlate).
        t_p = (st.rem.double() + ki.double() * step.double()).float()
        accs = []
        for off in offs:
            idx = (st.chip_off.to(torch.int64)
                   + torch.floor(t_p + f32(off)).to(torch.int64))
            c = code[torch.clamp(idx, 0, code.shape[0] - 1)]
            accs.append(((c * bb_i * mask).sum(), (c * bb_q * mask).sum()))
        (ie, qe), (ip, qp), (il, ql) = accs

        cross = ip * st.qp_prev - st.ip_prev * qp
        dot = ip * st.ip_prev + qp * st.qp_prev
        freq_err = torch.atan2(cross, torch.abs(dot)) * inv_pi
        denom = torch.where(torch.abs(ip) < 1e-10,
                            torch.full_like(ip, 1e-10), ip)
        carr_err = torch.atan(qp / denom) * inv_2pi
        carr_nco = (st.carr_nco + k1 * carr_err - k2 * st.old_carr_err
                    - k3 * freq_err)
        carr_delta = st.doppler_basis + carr_nco

        e = torch.sqrt(ie * ie + qe * qe)
        l_env = torch.sqrt(il * il + ql * ql)
        code_err = (e - l_env) / torch.clamp(e + l_env, min=1e-10)
        code_nco = (st.code_nco + c_dll_p * (code_err - st.old_code_err)
                    + code_err * c_dll_i)
        code_delta = -code_nco + carr_delta * inv_aid

        new_rem = st.rem + blk.to(torch.float32) * step - f32(BLOCK_CHIPS)
        new = PState(
            rem=new_rem, chip_off=st.chip_off + BLOCK_CHIPS,
            carr_phase_u32=(st.carr_phase_u32
                            + blk.to(torch.int64) * carr_step) & U32_MASK,
            sample_pos=st.sample_pos + blk,
            code_delta=code_delta, carr_delta=carr_delta,
            doppler_basis=st.doppler_basis, carr_nco=carr_nco,
            old_carr_err=carr_err, code_nco=code_nco,
            old_code_err=code_err, ip_prev=ip, qp_prev=qp)
        outs = {"ip": ip, "qp": qp, "ie": ie, "il": il,
                "carr_doppler": carr_delta, "code_err": code_err,
                "rem": new_rem, "blksize": blk}
        return new, outs

    def track(chunk, code, state: PState):
        outs = []
        for _ in range(n_blocks):
            state, o = one_block(chunk, code, state)
            outs.append(o)
        return state, {k: torch.stack([o[k] for o in outs])
                       for k in outs[0]}

    return track
