"""Per-family tracking-engine adapters for the live ChannelManager (port of
gnsstpu/tracking/engines.py, the 1 ms-code scan family).

ScanFamilyEngine drives GPS L1 C/A, GLONASS L1/L2 FDMA and BeiDou B1 over
the exact scan tracker ('gather' / 'table') or the fused K1 tracker
('fused'), and returns per-block observables in the EpochObs layout the
manager's supervision reads. The slot bank lives in host numpy arrays;
the manager mirrors it on the device and swaps rows in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gnsstpu.config import ReceiverConfig
from gnsstpu.signals.registry import get_signal


class EpochObs(NamedTuple):
    """Standardized per-block observables, [n_blocks, C] each."""

    ip: torch.Tensor
    qp: torch.Tensor
    ie: torch.Tensor
    qe: torch.Tensor
    il: torch.Tensor
    ql: torch.Tensor
    rem: torch.Tensor
    blksize: torch.Tensor
    dopp: torch.Tensor
    ip2: Optional[torch.Tensor] = None
    qp2: Optional[torch.Tensor] = None


def resolve_engine(mode: str = "auto") -> str:
    """'auto' is the fused K1 tracker on every device: on a CUDA tensor
    it launches the kernel, on a CPU tensor it runs K1's plain twin."""
    if mode == "auto":
        return "fused"
    if mode not in ("fused", "gather", "table"):
        raise ValueError(f"unknown engine {mode!r}")
    return mode


def make_engine(cfg: ReceiverConfig, mode: str = "auto"):
    """(signal family, engine mode) -> adapter instance."""
    name = cfg.signal.signal
    if name == "galileo_e1b":
        raise NotImplementedError(
            "Galileo E1B (BocEngine, kernel K2) is not ported yet: "
            "ROADMAP queue 1, 'the BOC family with K2'")
    if name == "glonass_l3oc":
        raise NotImplementedError(
            "GLONASS L3OC (DualEngine, kernel K3) is not ported yet: "
            "ROADMAP queue 1, 'the L3OC family with K3'")
    return ScanFamilyEngine(cfg, mode)


class ScanFamilyEngine:
    """1 ms-code families over tracking.scan or the fused K1 tracker."""

    has_data_component = False
    slot_keys = ("codes", "carr_base", "inv_aid")

    def __init__(self, cfg: ReceiverConfig, mode: str = "auto"):
        self.cfg = cfg
        self.sig = cfg.signal
        self.sd = get_signal(self.sig.signal)
        self.period_ms = int(round(self.sig.code_period_s * 1e3))
        self.spc = self.sig.samples_per_code
        #: rem (chips) times this = samples (abs_sample bookkeeping).
        self.rem_to_samples = self.sig.fs / self.sig.code_freq
        self.name = resolve_engine(mode)
        from gnsstpu.ops import code_tables
        if self.name == "fused":
            from gnsstpu_torch.tracking.fused import fused_code_table
            self._tab = fused_code_table(self.sig, cfg.track)
        elif self.name == "table":
            self._tab = code_tables.phase_row_table(
                self.sig.signal, self.sig.fs, self.sig.code_freq,
                self.sig.code_length, self.spc + 2)
        else:
            self._tab = code_tables.padded_code_table(self.sig.signal)

    def new_bank(self, C: int) -> dict:
        from gnsstpu_torch.tracking import scan as tscan

        cb, ia = tscan.channel_consts(self.sig, self.cfg.track, [1] * C)
        return {"codes": np.zeros((C,) + self._tab.shape[1:], np.float32),
                "carr_base": cb, "inv_aid": ia}

    def write_slot(self, bank: dict, idx: int, prn: int) -> None:
        from gnsstpu_torch.tracking import scan as tscan

        bank["codes"][idx] = self._tab[prn - 1]
        off = 0.0
        if self.sd.fdma_zero_prn is not None:
            off = (self.sd.carrier_freq(prn)
                   - self.sd.carrier_freq(self.sd.fdma_zero_prn))
        cb1, ia1 = tscan.channel_consts(
            self.sig, self.cfg.track, [prn], if_offsets_hz=[off])
        bank["carr_base"][idx] = cb1[0]
        bank["inv_aid"][idx] = ia1[0]

    def init_state(self, C: int, device):
        from gnsstpu_torch.tracking import scan as tscan

        return tscan.TrackState.init(
            np.zeros(C, np.int64), np.zeros(C, np.float32),
            aid_div=self.cfg.track.aid_div, device=device)

    def slot_state(self, doppler_hz: float, device):
        from gnsstpu_torch.tracking import scan as tscan

        return tscan.TrackState.init(
            np.zeros(1, np.int64), np.array([doppler_hz], np.float32),
            aid_div=self.cfg.track.aid_div, device=device)

    def make_step(self, n_blocks: int):
        if self.name == "fused":
            from gnsstpu_torch.tracking.fused import make_fused_tracker
            tracker = make_fused_tracker(self.sig, self.cfg.track,
                                         n_blocks=n_blocks)
        else:
            from gnsstpu_torch.tracking import scan as tscan
            tracker = tscan.make_tracker(self.sig, self.cfg.track,
                                         n_blocks=n_blocks,
                                         code_mode=self.name)

        def step(win, bank, state):
            state, out = tracker(
                win, bank["codes"], (bank["carr_base"], bank["inv_aid"]),
                state)
            obs = EpochObs(
                ip=out.ip, qp=out.qp, ie=out.ie, qe=out.qe,
                il=out.il, ql=out.ql, rem=out.rem_code_phase,
                blksize=out.blksize, dopp=out.carr_doppler)
            return state, obs

        return step
