"""Exact tracking engine: a loop over code-period blocks, channels batched
(port of gnsstpu/tracking/scan.py, whose lax.scan becomes a Python loop).

Per block it runs the correlator op, then the FLL-assisted PLL and the
carrier-aided DLL updates. It is the oracle the fused K1 tracker is held
against, and the engine behind the `gather` and `table` modes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gnsstpu_torch.config import SignalConfig, TrackConfig
from gnsstpu_torch.device import f32
from gnsstpu_torch.ops import correlate, nco
from gnsstpu_torch.ops.correlate import CorrState
from gnsstpu_torch.tracking import loop_filters


class TrackState(NamedTuple):
    """Full per-channel tracking state (CorrState + loop filter memory),
    [C] tensors."""

    corr: CorrState
    doppler_basis: torch.Tensor   # f32, acquired Doppler
    carr_nco: torch.Tensor        # f32 accumulated carrier NCO command [Hz]
    old_carr_err: torch.Tensor    # f32 previous phase error [cycles]
    code_nco: torch.Tensor        # f32 accumulated code NCO command [Hz]
    old_code_err: torch.Tensor    # f32 previous code error
    ip_prev: torch.Tensor         # f32 previous prompt I (FLL memory)
    qp_prev: torch.Tensor         # f32 previous prompt Q

    @staticmethod
    def init(code_phase_samples, doppler_hz, aid_div: float = 1540.0, *,
             device) -> "TrackState":
        """[C] state from host arrays; the code NCO starts carrier-aided
        and the FLL memory at 1e-3, as in the reference."""
        cp = torch.as_tensor(np.asarray(code_phase_samples, np.int64),
                             device=device).to(torch.int32)
        dp = torch.as_tensor(np.asarray(doppler_hz, np.float32),
                             device=device)
        z = torch.zeros_like(dp)
        eps = torch.full_like(dp, 1e-3)
        return TrackState(
            corr=CorrState(
                rem_code_phase=z,
                carr_phase_u32=torch.zeros_like(cp, dtype=torch.int64),
                sample_pos=cp,
                code_delta=dp / f32(aid_div),
                carr_delta=dp,
            ),
            doppler_basis=dp, carr_nco=z, old_carr_err=z, code_nco=z,
            old_code_err=z, ip_prev=eps, qp_prev=eps)


class TrackOut(NamedTuple):
    """Per-block, per-channel observables, [n_blocks, C] each."""

    ie: torch.Tensor
    qe: torch.Tensor
    ip: torch.Tensor
    qp: torch.Tensor
    il: torch.Tensor
    ql: torch.Tensor
    carr_doppler: torch.Tensor     # carrFreq - IF [Hz]
    code_freq_delta: torch.Tensor  # codeFreq - code basis [Hz]
    rem_code_phase: torch.Tensor   # chips, after the block
    blksize: torch.Tensor          # samples consumed
    dll_disc: torch.Tensor
    dll_disc_filt: torch.Tensor
    pll_disc: torch.Tensor
    pll_disc_filt: torch.Tensor


def channel_consts(sig: SignalConfig, trk: TrackConfig, prns,
                   if_offsets_hz=None):
    """Per-channel constants as host numpy: exact uint32 carrier NCO base
    steps [C] and f32 carrier-aiding divisors' inverses [C]. For FDMA,
    if_offsets_hz [C] gives each channel's carrier offset."""
    C = len(prns)
    offs = np.zeros(C) if if_offsets_hz is None else np.asarray(
        if_offsets_hz, np.float64)
    base = np.array(
        [nco.freq_to_step_u32(sig.if_freq + offs[c], sig.fs)
         for c in range(C)], np.uint32)
    inv_aid = np.full(C, 1.0 / trk.aid_div, np.float32)
    if if_offsets_hz is not None:
        f_carr0 = trk.aid_div * sig.code_freq
        inv_aid = (sig.code_freq / (f_carr0 + offs)).astype(np.float32)
    return base, inv_aid


def loop_coefs(trk: TrackConfig):
    """(k1, k2, k3, c_dll_p, c_dll_i) as Python floats."""
    tau1, tau2 = loop_filters.dll_coeffs(trk.dll_bw, trk.dll_damping, 1.0)
    k1, k2, k3 = loop_filters.fll_pll_coeffs(trk.pll_bw, trk.fll_bw,
                                             trk.pdi)
    return (float(k1), float(k2), float(k3), float(tau2 / tau1),
            float(trk.pdi / tau1))


def make_tracker(sig: SignalConfig, trk: TrackConfig, *, n_blocks: int,
                 blkmax: int | None = None, code_mode: str = "gather"):
    """Build the chunk tracker.

    code_mode: "gather" (exact per-sample code indexing) or "table"
    (phase-quantized rows + factored LO). codes is the padded code table
    [C, L+2] for "gather" or the phase-row table [C, 4*64, blkmax] for
    "table".

    Returns track_chunk(chunk [N, 2], codes, consts: (carr_base [C] int64,
    inv_aid [C] f32), state: TrackState) -> (new_state, TrackOut).
    """
    spc = sig.samples_per_code
    blkmax = blkmax or (spc + 2)
    k1, k2, k3, c_dll_p, c_dll_i = (f32(v) for v in loop_coefs(trk))
    kw = dict(blkmax=blkmax, spacing=trk.el_spacing,
              code_length=sig.code_length,
              base_code_step=float(np.float64(sig.code_freq) / sig.fs),
              inv_fs=1.0 / sig.fs)
    if code_mode == "table":
        corr_fn = correlate.correlate_block_fast
    elif code_mode == "gather":
        corr_fn = correlate.correlate_block
    else:
        raise ValueError(f"unknown code_mode {code_mode!r}")
    inv_pi = f32(1.0 / np.pi)
    inv_2pi = f32(1.0 / (2.0 * np.pi))

    def one_block(chunk, codes, carr_base, inv_aid, st: TrackState):
        out, cs = corr_fn(chunk, codes, carr_base, st.corr, **kw)
        i1, q1 = out.ip, out.qp
        cross = i1 * st.qp_prev - st.ip_prev * q1
        dot = i1 * st.ip_prev + q1 * st.qp_prev
        if trk.fll_disc == "atan":
            freq_err = torch.atan2(cross * torch.sign(dot),
                                   torch.abs(dot)) * inv_pi
        else:
            freq_err = torch.atan2(cross, torch.abs(dot)) * inv_pi
        denom = torch.where(torch.abs(i1) < 1e-10,
                            torch.full_like(i1, 1e-10), i1)
        carr_err = torch.atan(q1 / denom) * inv_2pi
        carr_nco = (st.carr_nco + k1 * carr_err - k2 * st.old_carr_err
                    - k3 * freq_err)
        carr_delta = st.doppler_basis + carr_nco
        e = torch.sqrt(out.ie * out.ie + out.qe * out.qe)
        l_env = torch.sqrt(out.il * out.il + out.ql * out.ql)
        code_err = (e - l_env) / torch.clamp(e + l_env, min=1e-10)
        code_nco = (st.code_nco + c_dll_p * (code_err - st.old_code_err)
                    + code_err * c_dll_i)
        code_delta = -code_nco + carr_delta * inv_aid
        new_state = TrackState(
            corr=cs._replace(code_delta=code_delta, carr_delta=carr_delta),
            doppler_basis=st.doppler_basis, carr_nco=carr_nco,
            old_carr_err=carr_err, code_nco=code_nco,
            old_code_err=code_err, ip_prev=i1, qp_prev=q1)
        tout = TrackOut(
            ie=out.ie, qe=out.qe, ip=out.ip, qp=out.qp, il=out.il,
            ql=out.ql, carr_doppler=carr_delta, code_freq_delta=code_delta,
            rem_code_phase=out.rem_code_phase, blksize=out.blksize,
            dll_disc=code_err, dll_disc_filt=code_nco, pll_disc=carr_err,
            pll_disc_filt=carr_nco)
        return new_state, tout

    def track_chunk(chunk, codes, consts, state: TrackState):
        carr_base, inv_aid = consts
        outs = []
        for _ in range(n_blocks):
            state, o = one_block(chunk, codes, carr_base, inv_aid, state)
            outs.append(o)
        return state, TrackOut(*(torch.stack(f) for f in zip(*outs)))

    return track_chunk
