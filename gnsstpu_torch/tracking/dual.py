"""Data + pilot dual-component tracking for GLONASS L3OC (port of
gnsstpu/tracking/dual.py).

Two engines with one interface, as the reference's:
  * make_dual_tracker — the exact scan engine (a loop over 1 ms blocks of
    the twelve-accumulator op ops.dualcode.correlate_block_dual, channels
    batched);
  * make_fused_dual_tracker — kernel K3 (ops.track_kernel.
    track_chunk_dual_fused): the state packed into its float lanes, its
    output lanes unpacked into the same state / output tuples.
Loops (reference GLONASS/L3/tracking.sci:355-396, with the reference's
choices): a Costas PLL atan(Q_P / I_P) on the pilot prompt, a
flip-invariant 2-quadrant FLL over consecutive pilot prompts, a DLL on the
normalized pilot E-L envelopes, and the code clock carrier-aided by
carrier / 117.5 (1202.025 MHz / 10.23 Mcps). The data prompts (ip2 / qp2)
are the demodulation observable (nav.glonass_l3).

The fused engine's tap table keeps the reference's values but only its
six planes (pilot E/P/L, data E/P/L), as int8 (the taps are exactly +-1)
without the TPU's two padding planes: tab [C, R, 6, bp], each plane padded
with zeros from blkp to bp = blkp rounded up to 128 lanes, as the TPU pads
its lanes.
track_dual is the offline chunked driver around either engine
(tracking.driver.run_chunks), with the reference's DualTrackResults; for
K3 its abs_sample takes off the replica's half slip
(tracking.driver.replica_slip_samples).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from gnsstpu_torch.config import SignalConfig, TrackConfig
from gnsstpu_torch.device import f32, resolve_device, u32_tensor
from gnsstpu_torch.ops import track_kernel as tk
from gnsstpu_torch.ops.dualcode import DualBlockOut, correlate_block_dual
from gnsstpu_torch.tracking import loop_filters
from gnsstpu_torch.tracking.scan import TrackState

PHASES_PER_CHIP = 64


class DualTrackOut(NamedTuple):
    """Per-block observables, [n_blocks, C] each."""

    acc: DualBlockOut
    carr_doppler: torch.Tensor
    code_freq_delta: torch.Tensor
    dll_disc: torch.Tensor
    pll_disc: torch.Tensor


def dual_coefs(sig: SignalConfig, trk: TrackConfig):
    """(k1, k2, k3, c_dll_p, c_dll_i) as Python floats; the loop update
    period is one 1 ms code period."""
    pdi = sig.code_period_s
    tau1, tau2 = loop_filters.dll_coeffs(trk.dll_bw, trk.dll_damping, 1.0)
    k1, k2, k3 = loop_filters.fll_pll_coeffs(trk.pll_bw, trk.fll_bw, pdi)
    return (float(k1), float(k2), float(k3), float(tau2 / tau1),
            float(pdi / tau1))


def make_dual_tracker(sig: SignalConfig, trk: TrackConfig, *,
                      n_blocks: int, blkmax: int | None = None):
    """The exact scan engine.

    Returns track_chunk(chunk [N, 2], pilot_codes [C, L + 2], data_codes
    [C, L + 2], carr_base [C] int64, state: TrackState) ->
    (state, DualTrackOut [n_blocks, C]).
    """
    blkmax = blkmax or (sig.samples_per_code + 2)
    k1, k2, k3, c_dll_p, c_dll_i = (f32(v) for v in dual_coefs(sig, trk))
    inv_aid = f32(1.0 / trk.aid_div)
    inv_pi = f32(1.0 / np.pi)
    inv_2pi = f32(1.0 / (2.0 * np.pi))
    kw = dict(blkmax=blkmax, spacing=trk.el_spacing,
              code_length=sig.code_length,
              base_code_step=float(np.float64(sig.code_freq) / sig.fs),
              inv_fs=1.0 / sig.fs)

    def one_block(chunk, pilot_codes, data_codes, carr_base,
                  st: TrackState):
        out, cs = correlate_block_dual(chunk, pilot_codes, data_codes,
                                       carr_base, st.corr, **kw)
        i1, q1 = out.ip, out.qp
        cross = i1 * st.qp_prev - st.ip_prev * q1
        dot = i1 * st.ip_prev + q1 * st.qp_prev
        # The NH overlay flips consecutive 1 ms prompts: 2-quadrant FLL.
        freq_err = torch.atan2(cross * torch.sign(dot),
                               torch.abs(dot)) * inv_pi
        denom = torch.where(torch.abs(i1) < 1e-10,
                            torch.full_like(i1, 1e-10), i1)
        carr_err = torch.atan(q1 / denom) * inv_2pi
        carr_nco = (st.carr_nco + k1 * carr_err - k2 * st.old_carr_err
                    - k3 * freq_err)
        carr_delta = st.doppler_basis + carr_nco
        code_err = tk.env_err(out.ie, out.qe, out.il, out.ql)
        code_nco = (st.code_nco + c_dll_p * (code_err - st.old_code_err)
                    + code_err * c_dll_i)
        code_delta = -code_nco + carr_delta * inv_aid
        new_state = TrackState(
            corr=cs._replace(code_delta=code_delta, carr_delta=carr_delta),
            doppler_basis=st.doppler_basis, carr_nco=carr_nco,
            old_carr_err=carr_err, code_nco=code_nco,
            old_code_err=code_err, ip_prev=i1, qp_prev=q1)
        tout = DualTrackOut(
            acc=out, carr_doppler=carr_delta, code_freq_delta=code_delta,
            dll_disc=code_err, pll_disc=carr_err)
        return new_state, tout

    def track_chunk(chunk, pilot_codes, data_codes, carr_base, state):
        outs = []
        for _ in range(n_blocks):
            state, o = one_block(chunk, pilot_codes, data_codes, carr_base,
                                 state)
            outs.append(o)
        acc = DualBlockOut(*(torch.stack(f) for f in zip(*(o.acc
                                                           for o in outs))))
        rest = (torch.stack(f) for f in zip(*(o[1:] for o in outs)))
        return state, DualTrackOut(acc, *rest)

    return track_chunk


@dataclasses.dataclass
class DualTrackResults:
    """[C, n_blocks] arrays at the 1 ms code-period cadence."""

    prn: np.ndarray
    i_p: np.ndarray
    q_p: np.ndarray
    i_e: np.ndarray
    q_e: np.ndarray
    i_l: np.ndarray
    q_l: np.ndarray
    i_p2: np.ndarray
    q_p2: np.ndarray
    carr_freq: np.ndarray
    code_freq: np.ndarray
    abs_sample: np.ndarray
    dll_disc: np.ndarray
    pll_disc: np.ndarray


def track_dual(source, channels: Sequence, sig: SignalConfig,
               trk: TrackConfig, n_ms: int, chunk_ms: int = 256,
               code_mode: str = "auto", *, device="cuda"
               ) -> DualTrackResults:
    """Chunked host driver for GLONASS L3OC data + pilot tracking on
    `device` ('cuda', the default; or 'cpu').

    channels: ChannelInit (tracking.driver); channels[].prn is the
    satellite number 1..31, the pilot code is code(prn) and the data code
    code(prn + 32) (signals.glonass_l3). code_mode: 'auto' or 'fused'
    (kernel K3, its tap table built for these satellites; its plain twin
    on the CPU) or 'gather' (the exact scan engine).
    """
    from gnsstpu_torch.ops import nco
    from gnsstpu_torch.signals import glonass_l3
    from gnsstpu_torch.tracking.driver import (chunk_samples,
                                               replica_slip_samples,
                                               run_chunks)
    from gnsstpu_torch.tracking.engines import resolve_engine

    dev = resolve_device(device)
    code_mode = resolve_engine(code_mode)
    prns = [ch.prn for ch in channels]
    if code_mode == "fused":
        tab = torch.as_tensor(dual_tap_rows(sig, trk, prns), device=dev)
        fused = make_fused_dual_tracker(sig, trk, n_blocks=chunk_ms)

        def step(chunk, cb, st):
            return fused(chunk, tab, cb, st)
    else:
        def codes(fn):
            return torch.as_tensor(np.stack([
                np.concatenate([c[-1:], c, c[:1]]).astype(np.float32)
                for c in (glonass_l3.generate_l3_code(fn(p))
                          for p in prns)]), device=dev)

        pilot = codes(glonass_l3.pilot_prn)
        data = codes(glonass_l3.data_prn)
        scan = make_dual_tracker(sig, trk, n_blocks=chunk_ms)

        def step(chunk, cb, st):
            return scan(chunk, pilot, data, cb, st)
    carr_base = u32_tensor(np.array(
        [nco.freq_to_step_u32(sig.if_freq + ch.if_offset_hz, sig.fs)
         for ch in channels], np.uint32), dev)
    state = TrackState.init(
        np.array([ch.code_phase for ch in channels], np.int64),
        np.array([ch.doppler_hz for ch in channels], np.float32),
        aid_div=trk.aid_div, device=dev)

    def tracker(chunk, st):
        st, out = step(chunk, carr_base, st)
        return st, {**out.acc._asdict(),
                    **{k: getattr(out, k) for k in out._fields[1:]}}

    f, ends = run_chunks(
        source, tracker, state, [ch.code_phase for ch in channels],
        chunk_len=chunk_samples(sig, n_ms, chunk_ms),
        n_chunks=int(np.ceil(n_ms / chunk_ms)), device=dev)
    f = {k: v[:, :n_ms] for k, v in f.items()}
    rem = f["rem_code_phase"].astype(np.float64)
    abs_sample = ends[:, :n_ms] - rem * (sig.fs / sig.code_freq)
    if code_mode == "fused":
        # K3's taps run at the nominal rate (tracking.driver).
        abs_sample = abs_sample + replica_slip_samples(
            f["code_freq_delta"], f["blksize"], sig.code_freq)
    return DualTrackResults(
        prn=np.array(prns),
        i_p=f["ip"], q_p=f["qp"], i_e=f["ie"], q_e=f["qe"],
        i_l=f["il"], q_l=f["ql"], i_p2=f["ip2"], q_p2=f["qp2"],
        carr_freq=sig.if_freq + f["carr_doppler"].astype(np.float64),
        code_freq=sig.code_freq + f["code_freq_delta"].astype(np.float64),
        abs_sample=abs_sample,
        dll_disc=f["dll_disc"], pll_disc=f["pll_disc"],
    )


# ---------------------------------------------------------------------------
# Fused engine (kernel K3): per-channel tap rows of both codes.
# ---------------------------------------------------------------------------


def dual_fused_span(sig: SignalConfig,
                    phases_per_chip: int = PHASES_PER_CHIP) -> float:
    """Table half-span in chips (copied from the reference): covers |rem|
    (< one code step per sample) plus rounding margin; the E/L spacing is
    baked into the tap planes, so it does not widen the span."""
    step = float(sig.code_freq) / float(sig.fs)
    need = step + 2.0 / phases_per_chip + 0.0625
    return float(np.ceil(need * 8.0) / 8.0)


def dual_table_shape(sig: SignalConfig,
                     phases_per_chip: int = PHASES_PER_CHIP) -> tuple:
    """(R, 6, bp): one channel's tap-row table shape, without building
    it (bp: blkp = samples_per_code + 2 rounded up to 128)."""
    span = dual_fused_span(sig, phases_per_chip)
    return (int(round(2 * span * phases_per_chip)), 6,
            tk.plane_stride(sig.samples_per_code + 2))


def dual_tap_rows(sig: SignalConfig, trk: TrackConfig, prns,
                  phases_per_chip: int = PHASES_PER_CHIP) -> np.ndarray:
    """Tap-row table for kernel K3, int8 [C, R, 6, bp] (host numpy).

    Row p, plane j holds the j-th tap waveform point-sampled at the
    nominal chip rate from chip phase (-span + p/ph + off_j), circularly:
    planes (pilot, data) x (E, P, L) with off = (-spacing, 0, +spacing),
    the DualBlockOut order. Each tap is the reference's expression
    (gnsstpu.tracking.dual.dual_fused_table), so the values equal its
    first six planes on lanes [0, blkp); lanes [blkp, bp) hold 0.
    """
    from gnsstpu_torch.signals import glonass_l3

    R, _, bp = dual_table_shape(sig, phases_per_chip)
    blkp = sig.samples_per_code + 2
    ph = phases_per_chip
    span = dual_fused_span(sig, ph)
    s = float(sig.code_freq) / float(sig.fs)
    sp = float(trk.el_spacing)
    k = np.arange(blkp, dtype=np.float64)
    p = np.arange(R, dtype=np.float64)
    idx = [np.floor(-span + off + p[:, None] / ph + k[None, :] * s
                    ).astype(np.int64) % sig.code_length
           for off in (-sp, 0.0, sp)]
    out = np.zeros((len(prns), R, 6, bp), np.int8)
    for i, prn in enumerate(prns):
        codes = (glonass_l3.generate_l3_code(glonass_l3.pilot_prn(prn)),
                 glonass_l3.generate_l3_code(glonass_l3.data_prn(prn)))
        for c, code in enumerate(codes):
            for e in range(3):
                out[i, :, 3 * c + e, :blkp] = code[idx[e]]
    return out


def dual_kernel_kwargs(sig: SignalConfig, trk: TrackConfig, *,
                       n_blocks: int,
                       phases_per_chip: int = PHASES_PER_CHIP) -> dict:
    """K3's static arguments for this signal and loop configuration."""
    return dict(
        n_blocks=n_blocks, blkp=sig.samples_per_code + 2,
        code_length=sig.code_length, phases_per_chip=phases_per_chip,
        span_chips=dual_fused_span(sig, phases_per_chip),
        base_code_step=float(np.float64(sig.code_freq) / sig.fs),
        fs=float(sig.fs), coefs=dual_coefs(sig, trk))


def dual_kernel_inputs(chunk, tab, carr_base, state: TrackState,
                       trk: TrackConfig) -> tuple:
    """K3's tensor arguments (chunk, tab, pos0, finit, cinit, carrbase):
    TrackState packed into the _F_* lanes of finit in the reference's
    order (gnsstpu/tracking/dual.py:316-321)."""
    c = state.corr
    C = carr_base.shape[0]
    inv_aid = torch.full((C,), f32(1.0 / trk.aid_div), device=chunk.device)
    lanes = [c.rem_code_phase, c.code_delta, c.carr_delta, state.carr_nco,
             state.old_carr_err, state.code_nco, state.old_code_err,
             state.ip_prev, state.qp_prev, state.doppler_basis, inv_aid]
    finit = torch.zeros((C, tk.NF), dtype=torch.float32, device=chunk.device)
    finit[:, :len(lanes)] = torch.stack(lanes, dim=1)
    return (chunk.contiguous(), tab, c.sample_pos.to(torch.int32), finit,
            c.carr_phase_u32.contiguous(), carr_base.contiguous())


def make_fused_dual_tracker(sig: SignalConfig, trk: TrackConfig, *,
                            n_blocks: int,
                            phases_per_chip: int = PHASES_PER_CHIP):
    """Fused-kernel dual tracker with the scan engine's tuples:
    track_chunk(chunk [N, 2], tab [C, R, 6, bp] int8, carr_base [C],
    state: TrackState) -> (state, DualTrackOut). The reference pads the
    chunk with 256 zero samples for its aligned window reads; K3 and its
    twin read zeros past the chunk's end instead."""
    kw = dual_kernel_kwargs(sig, trk, n_blocks=n_blocks,
                            phases_per_chip=phases_per_chip)

    def track_chunk(chunk, tab, carr_base, state: TrackState):
        out, ffin, posfin, cfin = tk.track_chunk_dual_fused(
            *dual_kernel_inputs(chunk, tab, carr_base, state, trk), **kw)
        new_state = TrackState(
            corr=state.corr._replace(
                rem_code_phase=ffin[:, tk._F_REM],
                carr_phase_u32=cfin, sample_pos=posfin,
                code_delta=ffin[:, tk._F_CODE_DELTA],
                carr_delta=ffin[:, tk._F_CARR_DELTA]),
            doppler_basis=state.doppler_basis,
            carr_nco=ffin[:, tk._F_CARR_NCO],
            old_carr_err=ffin[:, tk._F_OLD_CARR_ERR],
            code_nco=ffin[:, tk._F_CODE_NCO],
            old_code_err=ffin[:, tk._F_OLD_CODE_ERR],
            ip_prev=ffin[:, tk._F_IP_PREV], qp_prev=ffin[:, tk._F_QP_PREV])
        acc = DualBlockOut(
            *(out[:, :, lane] for lane in tk.OD_ACCS),
            blksize=out[:, :, tk.OD_BLKSIZE].to(torch.int32),
            rem_code_phase=out[:, :, tk.OD_REM])
        tout = DualTrackOut(
            acc=acc, carr_doppler=out[:, :, tk.OD_CARR_DOPPLER],
            code_freq_delta=out[:, :, tk.OD_CODE_FREQ_DELTA],
            dll_disc=out[:, :, tk.OD_DLL_DISC],
            pll_disc=out[:, :, tk.OD_PLL_DISC])
        return new_state, tout

    return track_chunk
