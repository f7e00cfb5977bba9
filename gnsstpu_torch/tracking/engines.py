"""Per-family tracking-engine adapters for the live ChannelManager (port of
gnsstpu/tracking/engines.py).

  * ScanFamilyEngine drives GPS L1 C/A, GLONASS L1/L2 FDMA and BeiDou B1
    over the exact scan tracker ('gather' / 'table') or the fused K1
    tracker ('fused');
  * BocEngine drives Galileo E1B (4 ms code periods) over the exact
    double-estimator scan ('boc') or kernel K2 ('boc_fused');
  * DualEngine drives GLONASS L3OC (pilot + data) over the exact dual scan
    ('dual') or kernel K3 ('dual_fused'), and hands the data-component
    prompts (ip2 / qp2) to the manager's history.
Each returns per-block observables in the EpochObs layout the manager's
supervision reads, so the manager is family-agnostic; one block is one
code period (period_ms). The slot bank lives in host numpy arrays; the
manager mirrors it on the device and swaps rows in place.

With a mesh, an engine's step runs per shard of mesh["channel"]
(parallel.fused_shard.shard_tracker), the port's analogue of the
reference's GSPMD (channels are independent): K1, K2 and K3 launch once
per shard, and the scan trackers run per shard. Unlike the reference,
whose shard_map wraps K1 alone, Galileo E1B and GLONASS L3OC keep their
kernels under a mesh.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gnsstpu_torch.config import ReceiverConfig
from gnsstpu_torch.signals.registry import get_signal


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
    """'auto' is the fused kernel on every device: on a CUDA tensor it
    launches the kernel, on a CPU tensor it runs the kernel's plain
    twin."""
    if mode == "auto":
        return "fused"
    if mode not in ("fused", "gather", "table"):
        raise ValueError(f"unknown engine {mode!r}")
    return mode


def make_engine(cfg: ReceiverConfig, mode: str = "auto", mesh=None):
    """(signal family, engine mode) -> adapter instance. mesh: a
    parallel.mesh.Mesh; the engine's step then runs on every shard of
    mesh["channel"] over its channel slice."""
    name = cfg.signal.signal
    fused = resolve_engine(mode) == "fused"
    if name == "galileo_e1b":
        return BocEngine(cfg, fused=fused, mesh=mesh)
    if name == "glonass_l3oc":
        return DualEngine(cfg, fused=fused, mesh=mesh)
    return ScanFamilyEngine(cfg, mode, mesh=mesh)


class _Base:
    has_data_component = False

    def __init__(self, cfg: ReceiverConfig, mesh=None):
        self.mesh = mesh
        self.cfg = cfg
        self.sig = cfg.signal
        self.sd = get_signal(self.sig.signal)
        self.period_ms = int(round(self.sig.code_period_s * 1e3))
        self.spc = self.sig.samples_per_code
        #: rem (chips of the pseudorange code) times this = samples
        #: (abs_sample bookkeeping).
        self.rem_to_samples = self.sig.fs / self.sig.code_freq

    def _sharded(self, tracker):
        """tracker itself, or run per shard of the mesh."""
        if self.mesh is None:
            return tracker
        from gnsstpu_torch.parallel.fused_shard import shard_tracker
        return shard_tracker(tracker, self.mesh)


class ScanFamilyEngine(_Base):
    """1 ms-code families over tracking.scan or the fused K1 tracker."""

    slot_keys = ("codes", "carr_base", "inv_aid")
    #: Bank keys with a leading channel dimension (split over a mesh).
    channel_keys = slot_keys

    def __init__(self, cfg: ReceiverConfig, mode: str = "auto",
                 mesh=None):
        super().__init__(cfg, mesh)
        self.name = resolve_engine(mode)
        from gnsstpu_torch.ops import code_tables

        if self.name == "fused":     # K1's int8 rows [.., R, bp]
            from gnsstpu_torch.tracking.fused import (fused_code_table,
                                                      fused_tap_rows)
            self._tab = fused_tap_rows(fused_code_table(self.sig, cfg.track))
        elif self.name == "table":
            self._tab = code_tables.phase_row_table(
                self.sig.signal, self.sig.fs, self.sig.code_freq,
                self.sig.code_length, self.spc + 2)
        else:
            self._tab = code_tables.padded_code_table(self.sig.signal)

    def new_bank(self, C: int) -> dict:
        from gnsstpu_torch.tracking import scan as tscan

        cb, ia = tscan.channel_consts(self.sig, self.cfg.track, [1] * C)
        # The fused engine's tap rows are int8, the scan engines' codes f32.
        return {"codes": np.zeros((C,) + self._tab.shape[1:],
                                  np.int8 if self.name == "fused"
                                  else np.float32),
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
            tracker = self._sharded(make_fused_tracker(
                self.sig, self.cfg.track, n_blocks=n_blocks))
        else:
            from gnsstpu_torch.tracking import scan as tscan
            tracker = self._sharded(tscan.make_tracker(
                self.sig, self.cfg.track, n_blocks=n_blocks,
                code_mode=self.name))

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


class BocEngine(_Base):
    """Galileo E1B double estimator (4 ms blocks) over the exact scan
    ('boc') or kernel K2 ('boc_fused').

    The pseudorange observable is the primary-code estimator, so rem is
    in primary chips (rem_to_samples = fs / 1.023 MHz). The fused
    engine's per-slot code tap rows are built when a PRN is written into
    a slot (the same values as the reference's table of all 50 PRNs,
    which is ~1.3 GB at 4.2 Msps), as int8 [Rc, 3, bp]; the meandr rows
    are shared.
    """

    slot_keys = ("codes",)
    channel_keys = ("codes", "carr_base")

    def __init__(self, cfg: ReceiverConfig, fused: bool, mesh=None):
        from gnsstpu_torch.signals import galileo_e1
        from gnsstpu_torch.tracking import boc

        super().__init__(cfg, mesh)
        # sig registry convention: code_freq/code_length at the meandr
        # rate; the primary code is half that (tracking.boc).
        self.rem_to_samples = self.sig.fs / (self.sig.code_freq / 2.0)
        self.name = "boc_fused" if fused else "boc"
        self.fused = fused
        if fused:
            self._sub = boc.sub_tap_rows(self.sig, cfg.track)
            self._row_shape = boc.code_tap_rows(self.sig, cfg.track,
                                                [1]).shape[1:]
        else:
            def pad(c):
                return np.concatenate([c[-1:], c, c[:1]]).astype(
                    np.float32)
            self._tab = np.stack(
                [pad(galileo_e1.primary_code(p))
                 for p in range(1, self.sd.num_prn + 1)])
            self._row_shape = self._tab.shape[1:]
            self._sub = pad(galileo_e1.subcarrier())

    def new_bank(self, C: int) -> dict:
        from gnsstpu_torch.ops import nco

        cb = np.full(C, nco.freq_to_step_u32(self.sig.if_freq,
                                             self.sig.fs), np.uint32)
        # The fused engine's tap rows are int8, the scan engine's codes f32.
        return {"codes": np.zeros((C,) + self._row_shape,
                                  np.int8 if self.fused else np.float32),
                "sub": np.asarray(self._sub), "carr_base": cb}

    def write_slot(self, bank: dict, idx: int, prn: int) -> None:
        if self.fused:
            from gnsstpu_torch.tracking.boc import code_tap_rows

            bank["codes"][idx] = code_tap_rows(self.sig, self.cfg.track,
                                               [prn])[0]
        else:
            bank["codes"][idx] = self._tab[prn - 1]

    def _state(self, code_phase, doppler_hz, device):
        from gnsstpu_torch.tracking.boc import BocTrackState

        return BocTrackState.init(code_phase, doppler_hz,
                                  aid_code=self.cfg.track.aid_div,
                                  aid_sub=self.cfg.track.aid_div / 2.0,
                                  device=device)

    def init_state(self, C: int, device):
        return self._state(np.zeros(C, np.int64), np.zeros(C, np.float32),
                           device)

    def slot_state(self, doppler_hz: float, device):
        return self._state(np.zeros(1, np.int64),
                           np.array([doppler_hz], np.float32), device)

    def make_step(self, n_blocks: int):
        from gnsstpu_torch.tracking import boc

        make = boc.make_fused_boc_tracker if self.fused \
            else boc.make_boc_tracker
        tracker = self._sharded(make(self.sig, self.cfg.track,
                                     n_blocks=n_blocks))

        def step(win, bank, state):
            state, out = tracker(win, bank["codes"], bank["sub"],
                                 bank["carr_base"], state)
            a = out.acc
            obs = EpochObs(
                ip=a.i_pp, qp=a.q_pp, ie=a.i_pe, qe=a.q_pe,
                il=a.i_pl, ql=a.q_pl, rem=a.rem_code_phase,
                blksize=a.blksize, dopp=out.carr_doppler)
            return state, obs

        return step


class DualEngine(_Base):
    """GLONASS L3OC pilot + data (1 ms blocks, 12 accumulators) over the
    exact dual scan ('dual') or kernel K3 ('dual_fused').

    Lock and the PLL ride the pilot; ip2 / qp2 carry the data prompts for
    overlay sync and demodulation (nav.glonass_l3). Slot PRNs are the
    satellite numbers 1..31: the pilot code is code(prn), the data code
    code(prn + 32). The fused engine's tap rows (int8 [R, 6, bp] per
    slot) are built when a PRN is written into a slot; new_bank sizes the
    table from its shape alone.
    """

    has_data_component = True

    def __init__(self, cfg: ReceiverConfig, fused: bool, mesh=None):
        super().__init__(cfg, mesh)
        self.name = "dual_fused" if fused else "dual"
        self.fused = fused
        self.slot_keys = ("tab",) if fused else ("pilot", "data")
        self.channel_keys = self.slot_keys + ("carr_base",)

    def new_bank(self, C: int) -> dict:
        from gnsstpu_torch.ops import nco

        cb = np.full(C, nco.freq_to_step_u32(self.sig.if_freq,
                                             self.sig.fs), np.uint32)
        bank = {"carr_base": cb}
        if self.fused:
            from gnsstpu_torch.tracking.dual import dual_table_shape
            bank["tab"] = np.zeros((C,) + dual_table_shape(self.sig),
                                   np.int8)
        else:
            L = self.sig.code_length + 2
            bank["pilot"] = np.zeros((C, L), np.float32)
            bank["data"] = np.zeros((C, L), np.float32)
        return bank

    def write_slot(self, bank: dict, idx: int, prn: int) -> None:
        from gnsstpu_torch.signals import glonass_l3 as l3

        if self.fused:
            from gnsstpu_torch.tracking.dual import dual_tap_rows
            bank["tab"][idx] = dual_tap_rows(self.sig, self.cfg.track,
                                             [prn])[0]
            return
        for key, code_prn in (("pilot", l3.pilot_prn(prn)),
                              ("data", l3.data_prn(prn))):
            c = l3.generate_l3_code(code_prn)
            bank[key][idx] = np.concatenate([c[-1:], c, c[:1]])

    def _state(self, n: int, doppler_hz, device):
        from gnsstpu_torch.tracking.scan import TrackState

        return TrackState.init(np.zeros(n, np.int64),
                               np.asarray(doppler_hz, np.float32),
                               aid_div=self.cfg.track.aid_div,
                               device=device)

    def init_state(self, C: int, device):
        return self._state(C, np.zeros(C), device)

    def slot_state(self, doppler_hz: float, device):
        return self._state(1, [doppler_hz], device)

    def make_step(self, n_blocks: int):
        from gnsstpu_torch.tracking import dual

        if self.fused:
            ftr = self._sharded(dual.make_fused_dual_tracker(
                self.sig, self.cfg.track, n_blocks=n_blocks))

            def tracker(win, bank, state):
                return ftr(win, bank["tab"], bank["carr_base"], state)
        else:
            dtr = self._sharded(dual.make_dual_tracker(
                self.sig, self.cfg.track, n_blocks=n_blocks))

            def tracker(win, bank, state):
                return dtr(win, bank["pilot"], bank["data"],
                           bank["carr_base"], state)

        def step(win, bank, state):
            state, out = tracker(win, bank, state)
            a = out.acc
            obs = EpochObs(
                ip=a.ip, qp=a.qp, ie=a.ie, qe=a.qe, il=a.il, ql=a.ql,
                rem=a.rem_code_phase, blksize=a.blksize,
                dopp=out.carr_doppler, ip2=a.ip2, qp2=a.qp2)
            return state, obs

        return step
