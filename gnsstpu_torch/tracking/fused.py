"""The fused K1 tracker behind the scan-tracker interface (port of
gnsstpu/tracking/fused.py).

make_fused_tracker() returns track_chunk(chunk, codes_tab, consts, state)
with the same signature and state/output tuples as
tracking.scan.make_tracker, so the engines and the ChannelManager switch
engines by name. It packs TrackState into K1's finit lanes (_F_*) and
unpacks K1's out lanes (O_*) into TrackOut, as the reference does. The
reference pads the chunk by 256 lanes for the TPU's aligned window reads;
the CUDA kernel reads at the cursor directly and needs no pad. codes_tab
is K1's int8 tap table (fused_tap_rows of fused_code_table).

E/L spacing is fractional: trk.el_spacing chips, realized at
1/phases_per_chip chip by picking early/late phase-table rows.
"""

from __future__ import annotations

import numpy as np
import torch

from gnsstpu_torch.config import SignalConfig, TrackConfig
from gnsstpu_torch.ops import code_tables
from gnsstpu_torch.ops import track_kernel as tk
from gnsstpu_torch.tracking.scan import TrackOut, TrackState, loop_coefs

PHASES_PER_CHIP = 64


def fused_span_chips(sig: SignalConfig, trk: TrackConfig,
                     phases_per_chip: int = PHASES_PER_CHIP) -> float:
    """Phase-row table half-span (copied from gnsstpu.tracking.fused):
    covers |rem_code_phase| plus the E/L spacing plus rounding margin,
    quantized to whole 1/8 chips."""
    step = float(sig.code_freq) / float(sig.fs)
    need = step + float(trk.el_spacing) + 2.0 / phases_per_chip + 0.0625
    return float(np.ceil(need * 8.0) / 8.0)


def fused_code_table(sig: SignalConfig, trk: TrackConfig, prns=None,
                     blkmax: int | None = None,
                     phases_per_chip: int = PHASES_PER_CHIP) -> np.ndarray:
    """Per-PRN phase-row table for K1, f32 [C, R, blkp] (host numpy;
    prns=None gives all PRNs). Copied from gnsstpu.tracking.fused."""
    blkp = blkmax or (sig.samples_per_code + 2)
    tab = code_tables.prompt_row_table(
        sig.signal, sig.fs, sig.code_freq, sig.code_length, blkp,
        phases_per_chip, span_chips=fused_span_chips(sig, trk,
                                                     phases_per_chip))
    if prns is None:
        return tab
    return np.stack([tab[p - 1] for p in prns])


def fused_tap_rows(tab: np.ndarray) -> np.ndarray:
    """K1's tap table from fused_code_table's f32 [.., R, blkp]: the same
    +-1 values as int8, each row padded with zeros to plane_stride(blkp)
    lanes, so every 16-tap vector of a row is 16-byte aligned."""
    blkp = tab.shape[-1]
    out = np.zeros(tab.shape[:-1] + (tk.plane_stride(blkp),), np.int8)
    out[..., :blkp] = tab
    return out


def kernel_kwargs(sig: SignalConfig, trk: TrackConfig, *, n_blocks: int,
                  blkmax: int | None = None,
                  phases_per_chip: int = PHASES_PER_CHIP) -> dict:
    """K1's static arguments for this signal and loop configuration."""
    return dict(
        n_blocks=n_blocks, blkp=blkmax or (sig.samples_per_code + 2),
        code_length=sig.code_length, phases_per_chip=phases_per_chip,
        spacing=float(trk.el_spacing),
        span_chips=fused_span_chips(sig, trk, phases_per_chip),
        base_code_step=float(np.float64(sig.code_freq) / sig.fs),
        fs=float(sig.fs), coefs=loop_coefs(trk), fll_disc=trk.fll_disc)


def kernel_inputs(chunk, codes_tab, consts, state: TrackState) -> tuple:
    """K1's tensor arguments (chunk, tab, pos0, finit, cinit, carrbase)
    from the scan-tracker interface: TrackState packed into the _F_*
    lanes of finit."""
    carr_base, inv_aid = consts
    c = state.corr
    lanes = [c.rem_code_phase, c.code_delta, c.carr_delta, state.carr_nco,
             state.old_carr_err, state.code_nco, state.old_code_err,
             state.ip_prev, state.qp_prev, state.doppler_basis,
             inv_aid.to(torch.float32)]
    finit = torch.zeros((len(c.rem_code_phase), tk.NF),
                        dtype=torch.float32, device=chunk.device)
    finit[:, :len(lanes)] = torch.stack(lanes, dim=1)
    return (chunk.contiguous(), codes_tab, c.sample_pos.to(torch.int32),
            finit, c.carr_phase_u32.contiguous(), carr_base.contiguous())


def make_fused_tracker(sig: SignalConfig, trk: TrackConfig, *,
                       n_blocks: int, blkmax: int | None = None,
                       phases_per_chip: int = PHASES_PER_CHIP):
    kw = kernel_kwargs(sig, trk, n_blocks=n_blocks, blkmax=blkmax,
                       phases_per_chip=phases_per_chip)

    def track_chunk(chunk, codes_tab, consts, state: TrackState):
        out, ffin, posfin, cfin = tk.track_chunk_fused(
            *kernel_inputs(chunk, codes_tab, consts, state), **kw)
        new_state = TrackState(
            corr=state.corr._replace(
                rem_code_phase=ffin[:, tk._F_REM],
                carr_phase_u32=cfin,
                sample_pos=posfin,
                code_delta=ffin[:, tk._F_CODE_DELTA],
                carr_delta=ffin[:, tk._F_CARR_DELTA]),
            doppler_basis=state.doppler_basis,
            carr_nco=ffin[:, tk._F_CARR_NCO],
            old_carr_err=ffin[:, tk._F_OLD_CARR_ERR],
            code_nco=ffin[:, tk._F_CODE_NCO],
            old_code_err=ffin[:, tk._F_OLD_CODE_ERR],
            ip_prev=ffin[:, tk._F_IP_PREV],
            qp_prev=ffin[:, tk._F_QP_PREV])
        tout = TrackOut(
            ie=out[:, :, tk.O_IE], qe=out[:, :, tk.O_QE],
            ip=out[:, :, tk.O_IP], qp=out[:, :, tk.O_QP],
            il=out[:, :, tk.O_IL], ql=out[:, :, tk.O_QL],
            carr_doppler=out[:, :, tk.O_CARR_DOPPLER],
            code_freq_delta=out[:, :, tk.O_CODE_FREQ_DELTA],
            rem_code_phase=out[:, :, tk.O_REM],
            blksize=out[:, :, tk.O_BLKSIZE].to(torch.int32),
            dll_disc=out[:, :, tk.O_DLL_DISC],
            dll_disc_filt=out[:, :, tk.O_DLL_FILT],
            pll_disc=out[:, :, tk.O_PLL_DISC],
            pll_disc_filt=out[:, :, tk.O_PLL_FILT])
        return new_state, tout

    return track_chunk
