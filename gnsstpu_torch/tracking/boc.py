"""Double-estimator BOC tracking for Galileo E1: DLL + SLL + FLL-assisted
PLL (port of gnsstpu/tracking/boc.py).

Two engines with one interface, as the reference's:
  * make_boc_tracker — the exact scan engine (a loop over 4 ms blocks of
    the ten-correlator op ops.boc.correlate_block_boc, channels batched);
  * make_fused_boc_tracker — kernel K2 (ops.track_kernel.
    track_chunk_boc_fused): the state packed into its 16 float lanes, its
    24 output lanes unpacked into the same state / output tuples.
track_boc is the offline chunked driver around either engine
(tracking.driver.run_chunks), with the reference's BocTrackResults; for
K2 its abs_sample takes off the replica's half slip
(tracking.driver.replica_slip_samples).
Loops (reference GALILEO/E1/tracking.sci:300-430): PLL/FLL on P_P, the DLL
on normalized |P_E| - |P_L| with the code clock aided by carrier/1540, the
SLL on normalized |E_P| - |L_P| with the meandr clock aided by
carrier/770. The pseudorange observable is the code estimator.

The fused engine's tap tables keep the reference's values but only its
three E/P/L planes, as int8 (every tap is +-1), each plane padded with
zeros from blkp to bp = blkp rounded up to 128 lanes: ctab [C, Rc, 3, bp]
per channel, stab [Rs, 3, bp] shared.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from gnsstpu_torch.config import SignalConfig, TrackConfig
from gnsstpu_torch.device import f32, resolve_device, u32_tensor
from gnsstpu_torch.ops import track_kernel as tk
from gnsstpu_torch.ops.boc import (BocBlockOut, BocCorrState,
                                   correlate_block_boc)
from gnsstpu_torch.tracking import loop_filters

PHASES_PER_CHIP = 64


class BocTrackState(NamedTuple):
    """Per-channel double-estimator state, [C] tensors."""

    corr: BocCorrState
    doppler_basis: torch.Tensor
    carr_nco: torch.Tensor
    old_carr_err: torch.Tensor
    code_nco: torch.Tensor
    old_code_err: torch.Tensor
    sll_nco: torch.Tensor
    old_sll_err: torch.Tensor
    ip_prev: torch.Tensor
    qp_prev: torch.Tensor

    @staticmethod
    def init(code_phase_samples, doppler_hz, aid_code: float = 1540.0,
             aid_sub: float = 770.0, *, device) -> "BocTrackState":
        """[C] state from host arrays: both clocks start carrier-aided,
        the FLL memory at 1e-3, as in the reference."""
        cp = torch.as_tensor(np.asarray(code_phase_samples, np.int64),
                             device=device).to(torch.int32)
        dp = torch.as_tensor(np.asarray(doppler_hz, np.float32),
                             device=device)
        z = torch.zeros_like(dp)
        eps = torch.full_like(dp, 1e-3)
        return BocTrackState(
            corr=BocCorrState(
                rem_code_phase=z, rem_sub_phase=z,
                carr_phase_u32=torch.zeros_like(cp, dtype=torch.int64),
                sample_pos=cp, code_delta=dp / f32(aid_code),
                sub_delta=dp / f32(aid_sub), carr_delta=dp),
            doppler_basis=dp, carr_nco=z, old_carr_err=z, code_nco=z,
            old_code_err=z, sll_nco=z, old_sll_err=z, ip_prev=eps,
            qp_prev=eps)


class BocTrackOut(NamedTuple):
    """Per-block observables, [n_blocks, C] each."""

    acc: BocBlockOut
    carr_doppler: torch.Tensor
    code_freq_delta: torch.Tensor
    sub_freq_delta: torch.Tensor
    dll_disc: torch.Tensor
    sll_disc: torch.Tensor
    pll_disc: torch.Tensor


def boc_coefs(sig: SignalConfig, trk: TrackConfig):
    """(k1, k2, k3, c_dll_p, c_dll_i, c_sll_p, c_sll_i) as Python floats;
    the loop update period is one 4 ms code period."""
    pdi = sig.code_period_s
    tau1c, tau2c = loop_filters.dll_coeffs(trk.dll_bw, trk.dll_damping, 1.0)
    tau1s, tau2s = loop_filters.dll_coeffs(trk.sll_bw, trk.sll_damping, 1.0)
    k1, k2, k3 = loop_filters.fll_pll_coeffs(trk.pll_bw, trk.fll_bw, pdi)
    return (float(k1), float(k2), float(k3), float(tau2c / tau1c),
            float(pdi / tau1c), float(tau2s / tau1s), float(pdi / tau1s))


def make_boc_tracker(sig: SignalConfig, trk: TrackConfig, *, n_blocks: int,
                     blkmax: int | None = None):
    """The exact scan engine. sig follows the registry convention for
    'galileo_e1b': code_freq / code_length describe the composite at the
    meandr (half-chip) rate; the primary code is half that.

    Returns track_chunk(chunk [N, 2], padded_codes [C, L/2 + 2],
    padded_sub [L + 2], carr_base [C] int64, state) -> (state, BocTrackOut).
    """
    sub_len = sig.code_length
    code_len = sub_len // 2
    blkmax = blkmax or (sig.samples_per_code + 2)
    k1, k2, k3, c_dll_p, c_dll_i, c_sll_p, c_sll_i = (
        f32(v) for v in boc_coefs(sig, trk))
    # trk.aid_div = f_carrier / f_code(primary) = 1540 for E1; the meandr
    # clock is 2x the code clock -> /770.
    inv_aid_code = f32(1.0 / trk.aid_div)
    inv_aid_sub = f32(2.0 / trk.aid_div)
    kw = dict(blkmax=blkmax, code_spacing=trk.el_spacing,
              sub_spacing=trk.sll_spacing, code_length=code_len,
              sub_length=sub_len,
              base_code_step=float(np.float64(sig.code_freq / 2.0) / sig.fs),
              base_sub_step=float(np.float64(sig.code_freq) / sig.fs),
              inv_fs=1.0 / sig.fs)
    inv_pi = f32(1.0 / np.pi)
    inv_2pi = f32(1.0 / (2.0 * np.pi))
    env_err = tk.env_err

    def one_block(chunk, padded_code, padded_sub, carr_base,
                  st: BocTrackState):
        out, cs = correlate_block_boc(chunk, padded_code, padded_sub,
                                      carr_base, st.corr, **kw)
        i1, q1 = out.i_pp, out.q_pp
        cross = i1 * st.qp_prev - st.ip_prev * q1
        dot = i1 * st.ip_prev + q1 * st.qp_prev
        # 250 sps I/NAV symbols flip sign every block: the flip-invariant
        # 2-quadrant FLL.
        freq_err = torch.atan2(cross * torch.sign(dot),
                               torch.abs(dot)) * inv_pi
        denom = torch.where(torch.abs(i1) < 1e-10,
                            torch.full_like(i1, 1e-10), i1)
        carr_err = torch.atan(q1 / denom) * inv_2pi
        carr_nco = (st.carr_nco + k1 * carr_err - k2 * st.old_carr_err
                    - k3 * freq_err)
        carr_delta = st.doppler_basis + carr_nco
        code_err = env_err(out.i_pe, out.q_pe, out.i_pl, out.q_pl)
        code_nco = (st.code_nco + c_dll_p * (code_err - st.old_code_err)
                    + code_err * c_dll_i)
        code_delta = -code_nco + carr_delta * inv_aid_code
        sll_err = env_err(out.i_ep, out.q_ep, out.i_lp, out.q_lp)
        sll_nco = (st.sll_nco + c_sll_p * (sll_err - st.old_sll_err)
                   + sll_err * c_sll_i)
        sub_delta = -sll_nco + carr_delta * inv_aid_sub
        new_state = BocTrackState(
            corr=cs._replace(code_delta=code_delta, sub_delta=sub_delta,
                             carr_delta=carr_delta),
            doppler_basis=st.doppler_basis, carr_nco=carr_nco,
            old_carr_err=carr_err, code_nco=code_nco,
            old_code_err=code_err, sll_nco=sll_nco, old_sll_err=sll_err,
            ip_prev=i1, qp_prev=q1)
        tout = BocTrackOut(
            acc=out, carr_doppler=carr_delta, code_freq_delta=code_delta,
            sub_freq_delta=sub_delta, dll_disc=code_err, sll_disc=sll_err,
            pll_disc=carr_err)
        return new_state, tout

    def track_chunk(chunk, padded_codes, padded_sub, carr_base, state):
        outs = []
        for _ in range(n_blocks):
            state, o = one_block(chunk, padded_codes, padded_sub, carr_base,
                                 state)
            outs.append(o)
        acc = BocBlockOut(*(torch.stack(f) for f in zip(*(o.acc
                                                          for o in outs))))
        rest = (torch.stack(f) for f in zip(*(o[1:] for o in outs)))
        return state, BocTrackOut(acc, *rest)

    return track_chunk


@dataclasses.dataclass
class BocTrackResults:
    """[C, n_blocks] arrays at the code-period (4 ms) cadence."""

    prn: np.ndarray
    i_pp: np.ndarray
    q_pp: np.ndarray
    i_pe: np.ndarray
    q_pe: np.ndarray
    i_pl: np.ndarray
    q_pl: np.ndarray
    i_ep: np.ndarray
    q_ep: np.ndarray
    i_lp: np.ndarray
    q_lp: np.ndarray
    carr_freq: np.ndarray
    code_freq: np.ndarray
    sub_freq: np.ndarray
    abs_sample: np.ndarray
    dll_disc: np.ndarray
    sll_disc: np.ndarray
    pll_disc: np.ndarray


def track_boc(source, channels: Sequence, sig: SignalConfig,
              trk: TrackConfig, n_blocks: int, chunk_blocks: int = 128,
              code_mode: str = "auto", *, device="cuda") -> BocTrackResults:
    """Chunked host driver around the BOC engines (Galileo E1B) on
    `device` ('cuda', the default; or 'cpu'). channels: ChannelInit
    (tracking.driver); n_blocks counts 4 ms code periods.

    code_mode: 'auto' or 'fused' (kernel K2, its tap tables built for
    these PRNs; its plain twin on the CPU) or 'gather' (the exact scan
    engine)."""
    from gnsstpu_torch.ops import nco
    from gnsstpu_torch.signals import galileo_e1
    from gnsstpu_torch.tracking.driver import (chunk_samples,
                                               replica_slip_samples,
                                               run_chunks)
    from gnsstpu_torch.tracking.engines import resolve_engine

    dev = resolve_device(device)
    code_mode = resolve_engine(code_mode)
    prns = [ch.prn for ch in channels]

    if code_mode == "fused":
        ctab, stab, _, _ = boc_fused_tables(sig, trk, prns)
        step = make_fused_boc_tracker(sig, trk, n_blocks=chunk_blocks)
    else:
        def pad(c):
            return np.concatenate([c[-1:], c, c[:1]]).astype(np.float32)

        ctab = np.stack([pad(galileo_e1.primary_code(p)) for p in prns])
        stab = pad(galileo_e1.subcarrier())
        step = make_boc_tracker(sig, trk, n_blocks=chunk_blocks)
    ctab = torch.as_tensor(ctab, device=dev)
    stab = torch.as_tensor(stab, device=dev)
    carr_base = u32_tensor(np.array(
        [nco.freq_to_step_u32(sig.if_freq + ch.if_offset_hz, sig.fs)
         for ch in channels], np.uint32), dev)
    state = BocTrackState.init(
        np.array([ch.code_phase for ch in channels], np.int64),
        np.array([ch.doppler_hz for ch in channels], np.float32),
        device=dev)

    def tracker(chunk, st):
        st, out = step(chunk, ctab, stab, carr_base, st)
        return st, {**out.acc._asdict(),
                    **{k: getattr(out, k) for k in out._fields[1:]}}

    f, ends = run_chunks(
        source, tracker, state, [ch.code_phase for ch in channels],
        chunk_len=chunk_samples(sig, n_blocks, chunk_blocks,
                                sig.code_period_s),
        n_chunks=int(np.ceil(n_blocks / chunk_blocks)), device=dev)
    f = {k: v[:, :n_blocks] for k, v in f.items()}
    rem = f["rem_code_phase"].astype(np.float64)
    abs_sample = (ends[:, :n_blocks]
                  - rem * (sig.fs / (sig.code_freq / 2.0)))
    if code_mode == "fused":
        # K2's code taps run at the nominal rate (tracking.driver).
        abs_sample = abs_sample + replica_slip_samples(
            f["code_freq_delta"], f["blksize"], sig.code_freq / 2.0)
    return BocTrackResults(
        prn=np.array(prns),
        i_pp=f["i_pp"], q_pp=f["q_pp"], i_pe=f["i_pe"], q_pe=f["q_pe"],
        i_pl=f["i_pl"], q_pl=f["q_pl"], i_ep=f["i_ep"], q_ep=f["q_ep"],
        i_lp=f["i_lp"], q_lp=f["q_lp"],
        carr_freq=sig.if_freq + f["carr_doppler"].astype(np.float64),
        code_freq=sig.code_freq / 2.0 + f["code_freq_delta"].astype(
            np.float64),
        sub_freq=sig.code_freq + f["sub_freq_delta"].astype(np.float64),
        abs_sample=abs_sample,
        dll_disc=f["dll_disc"], sll_disc=f["sll_disc"],
        pll_disc=f["pll_disc"],
    )


# ---------------------------------------------------------------------------
# Fused engine (kernel K2): per-channel primary-code tap rows + shared
# meandr tap rows.
# ---------------------------------------------------------------------------


def _boc_spans(sig: SignalConfig, ph: int):
    """(span_code, span_sub) in their own clock units (copied from the
    reference). The code estimator's remainder stays within one code step
    per sample; the sub estimator's remainder also carries the
    double-estimator offset (the SLL may sit up to ~half a half-chip away
    from 2x the code delay), so its span includes that excursion."""
    step_c = float(sig.code_freq / 2.0) / float(sig.fs)
    step_s = float(sig.code_freq) / float(sig.fs)
    span_c = float(np.ceil((step_c + 2.0 / ph + 0.0625) * 8.0) / 8.0)
    span_s = float(np.ceil((step_s + 0.625 + 2.0 / ph + 0.0625)
                           * 8.0) / 8.0)
    return span_c, span_s


def _tap_table(codes, length: int, fs: float, freq: float, blkp: int,
               spacing: float, ph: int, span: float) -> np.ndarray:
    """Tap-row table [N, R, 3, bp] int8 with E/P/L planes at (-spacing,
    0, +spacing) units of the given clock: the reference's values (the
    +-1 int8 codes), each tap computed by the reference's expression, on
    lanes [0, blkp); lanes [blkp, bp) hold 0."""
    step = float(freq) / float(fs)
    rows = int(round(2 * span * ph))
    k = np.arange(blkp, dtype=np.float64)
    p = np.arange(rows, dtype=np.float64)
    out = np.zeros((len(codes), rows, 3, tk.plane_stride(blkp)), np.int8)
    for j, off in enumerate((-spacing, 0.0, spacing)):
        idx = np.floor(-span + off + p[:, None] / ph
                       + k[None, :] * step).astype(np.int64) % length
        for i, code in enumerate(codes):
            out[i, :, j, :blkp] = code[idx]
    return out


def code_tap_rows(sig: SignalConfig, trk: TrackConfig, prns,
                  ph: int = PHASES_PER_CHIP) -> np.ndarray:
    """Primary-code tap rows int8 [C, Rc, 3, bp] of the given PRNs."""
    from gnsstpu_torch.signals import galileo_e1

    return _tap_table(
        [galileo_e1.primary_code(p) for p in prns], sig.code_length // 2,
        sig.fs, sig.code_freq / 2.0, sig.samples_per_code + 2,
        trk.el_spacing, ph, _boc_spans(sig, ph)[0])


def sub_tap_rows(sig: SignalConfig, trk: TrackConfig,
                 ph: int = PHASES_PER_CHIP) -> np.ndarray:
    """Meandr (subcarrier) tap rows int8 [Rs, 3, bp], shared by all
    PRNs."""
    from gnsstpu_torch.signals import galileo_e1

    return _tap_table(
        [galileo_e1.subcarrier()], sig.code_length, sig.fs, sig.code_freq,
        sig.samples_per_code + 2, trk.sll_spacing, ph,
        _boc_spans(sig, ph)[1])[0]


def boc_fused_tables(sig: SignalConfig, trk: TrackConfig, prns,
                     ph: int = PHASES_PER_CHIP):
    """(code_tab [C, Rc, 3, bp], sub_tab [Rs, 3, bp], span_c, span_s)
    for kernel K2 (host numpy, int8). sig follows the galileo_e1b registry
    convention (code_freq / code_length at the meandr rate)."""
    span_c, span_s = _boc_spans(sig, ph)
    return (code_tap_rows(sig, trk, prns, ph), sub_tap_rows(sig, trk, ph),
            span_c, span_s)


def boc_kernel_kwargs(sig: SignalConfig, trk: TrackConfig, *,
                      n_blocks: int, ph: int = PHASES_PER_CHIP) -> dict:
    """K2's static arguments for this signal and loop configuration."""
    span_c, span_s = _boc_spans(sig, ph)
    return dict(
        n_blocks=n_blocks, blkp=sig.samples_per_code + 2,
        code_length=sig.code_length // 2, sub_length=sig.code_length,
        ph_code=ph, ph_sub=ph, span_code=span_c, span_sub=span_s,
        base_code_step=float(np.float64(sig.code_freq / 2.0) / sig.fs),
        base_sub_step=float(np.float64(sig.code_freq) / sig.fs),
        fs=float(sig.fs), coefs=boc_coefs(sig, trk))


def boc_kernel_inputs(chunk, ctab, stab, carr_base, state: BocTrackState,
                      trk: TrackConfig) -> tuple:
    """K2's tensor arguments (chunk, ctab, stab, pos0, finit, cinit,
    carrbase): BocTrackState packed into the 16 _F_* lanes of finit."""
    c = state.corr
    C = carr_base.shape[0]
    dev = chunk.device
    inv_aid = torch.full((C,), f32(1.0 / trk.aid_div), device=dev)
    inv_aid_sub = torch.full((C,), f32(2.0 / trk.aid_div), device=dev)
    finit = torch.stack(
        [c.rem_code_phase, c.code_delta, c.carr_delta, state.carr_nco,
         state.old_carr_err, state.code_nco, state.old_code_err,
         state.ip_prev, state.qp_prev, state.doppler_basis, inv_aid,
         c.rem_sub_phase, c.sub_delta, state.sll_nco, state.old_sll_err,
         inv_aid_sub], dim=1).to(torch.float32).contiguous()
    return (chunk.contiguous(), ctab, stab, c.sample_pos.to(torch.int32),
            finit, c.carr_phase_u32.contiguous(), carr_base.contiguous())


def make_fused_boc_tracker(sig: SignalConfig, trk: TrackConfig, *,
                           n_blocks: int, ph: int = PHASES_PER_CHIP):
    """Fused-kernel BOC tracker with the scan engine's tuples:
    track_chunk(chunk [N, 2], ctab, stab, carr_base [C], state) ->
    (state, BocTrackOut)."""
    kw = boc_kernel_kwargs(sig, trk, n_blocks=n_blocks, ph=ph)

    def track_chunk(chunk, ctab, stab, carr_base, state: BocTrackState):
        out, ffin, posfin, cfin = tk.track_chunk_boc_fused(
            *boc_kernel_inputs(chunk, ctab, stab, carr_base, state, trk),
            **kw)
        new_state = BocTrackState(
            corr=state.corr._replace(
                rem_code_phase=ffin[:, tk._F_REM],
                rem_sub_phase=ffin[:, tk._F_REM_SUB],
                carr_phase_u32=cfin, sample_pos=posfin,
                code_delta=ffin[:, tk._F_CODE_DELTA],
                sub_delta=ffin[:, tk._F_SUB_DELTA],
                carr_delta=ffin[:, tk._F_CARR_DELTA]),
            doppler_basis=state.doppler_basis,
            carr_nco=ffin[:, tk._F_CARR_NCO],
            old_carr_err=ffin[:, tk._F_OLD_CARR_ERR],
            code_nco=ffin[:, tk._F_CODE_NCO],
            old_code_err=ffin[:, tk._F_OLD_CODE_ERR],
            sll_nco=ffin[:, tk._F_SLL_NCO],
            old_sll_err=ffin[:, tk._F_OLD_SLL_ERR],
            ip_prev=ffin[:, tk._F_IP_PREV], qp_prev=ffin[:, tk._F_QP_PREV])
        acc = BocBlockOut(
            *(out[:, :, lane] for lane in tk.OB_ACCS),
            blksize=out[:, :, tk.OB_BLKSIZE].to(torch.int32),
            rem_code_phase=out[:, :, tk.OB_REM],
            rem_sub_phase=out[:, :, tk.OB_REM_SUB])
        tout = BocTrackOut(
            acc=acc, carr_doppler=out[:, :, tk.OB_CARR_DOPPLER],
            code_freq_delta=out[:, :, tk.OB_CODE_FREQ_DELTA],
            sub_freq_delta=out[:, :, tk.OB_SUB_FREQ_DELTA],
            dll_disc=out[:, :, tk.OB_DLL_DISC],
            sll_disc=out[:, :, tk.OB_SLL_DISC],
            pll_disc=out[:, :, tk.OB_PLL_DISC])
        return new_state, tout

    return track_chunk
