"""Full receiver pipeline: acquire -> track -> decode -> navigate (port
of gnsstpu/runtime/receiver.py).

The framework's equivalent of the reference's top-level run scripts
(GPS/L1/postProcessing.sce:60-144 for the offline flow). run_receiver
runs the acquisition search and the chunked tracker on `device` (the
card by default: kernel K1, or K2 for galileo_e1b; the CPU runs their
plain twins) and the nav-message decode and navigation on the host. The
decode and navigation half is the reference's, line for line, on the
port's copies of gnsstpu.nav. Each ReceiverOutput also carries the wall
seconds of its three stages (stage_s: acquisition, track, decode and
navigation), read after the device's work for the stage is done.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from gnsstpu_torch.acquisition.search import AcqResults
from gnsstpu_torch.config import ReceiverConfig
from gnsstpu_torch.nav import frame, lnav, pvt
from gnsstpu_torch.nav.frame import FrameSync
from gnsstpu_torch.nav.types import Ephemeris
from gnsstpu_torch.signals.registry import get_signal
from gnsstpu_torch.tracking.driver import ChannelInit, TrackResults, track


@dataclasses.dataclass
class NavAnchor:
    """Per-channel time anchor from the nav-message decoder: prompt-record
    index (code periods) whose code start was transmitted at satellite
    time t_anchor. GPS: first subframe start/TOW; GLONASS: time-mark
    start (findTimeMarks.sci); BeiDou: first subframe/SOW; Galileo: page
    boundary/GST TOW."""

    found: bool = False
    anchor_idx: int = -1
    t_anchor: float = 0.0


@dataclasses.dataclass
class ReceiverOutput:
    acq: AcqResults
    channels: List[ChannelInit]
    track: Optional[TrackResults]
    syncs: List[FrameSync]
    ephs: Dict[int, Ephemeris]        # by PRN
    tows: Dict[int, float]            # TOW [s] at first subframe, by PRN
    nav: Optional[pvt.NavSolutions]
    anchors: List[NavAnchor] = dataclasses.field(default_factory=list)
    #: Wall seconds per stage: 'acquire', 'track', 'decode_nav'.
    stage_s: Dict[str, float] = dataclasses.field(default_factory=dict)


def allocate_channels(acq: AcqResults, n_channels: int,
                      sd=None, if_freq: float = 0.0) -> List[ChannelInit]:
    """Strongest-first channel allocation (preRun.sci:26-34 +
    simple_cold_allocate, osgnss_next_step.c:73-84). acq.carr_freq is the
    ABSOLUTE acquired carrier (centered on the front end's IF), while
    ChannelInit.doppler_hz must exclude the IF (channel_consts bakes
    if_freq into the carrier NCO base) — pass the signal's if_freq. For
    FDMA signals the per-channel carrier offset is additionally split
    out so doppler_hz is true Doppler (GLONASS L1_IF_step)."""
    order = np.argsort(-acq.peak_metric)
    chans = []
    for i in order:
        if not acq.detected[i] or len(chans) >= n_channels:
            continue
        prn = int(i) + 1
        off = 0.0
        if sd is not None and sd.fdma_zero_prn is not None:
            off = sd.carrier_freq(prn) - sd.carrier_freq(sd.fdma_zero_prn)
        chans.append(ChannelInit(
            prn=prn,
            code_phase=int(acq.code_phase[i]),
            doppler_hz=float(acq.carr_freq[i]) - if_freq - off,
            if_offset_hz=off))
    return chans


def run_receiver(source, cfg: ReceiverConfig, n_ms: Optional[int] = None,
                 *, device="cuda") -> ReceiverOutput:
    """Run the full chain on a sample source, the acquisition search and
    the tracker on `device` ('cuda', the default, raises on a host
    without a card; or 'cpu')."""
    from gnsstpu_torch.acquisition.search import (acq_samples_needed,
                                                  acquire, acquire_fdma)
    from gnsstpu_torch.device import resolve_device

    dev = resolve_device(device)
    sig = cfg.signal
    n_ms = n_ms or cfg.ms_to_process
    sd = get_signal(sig.signal)
    stage_s = {}

    t0 = time.perf_counter()
    samples = source.read(0, acq_samples_needed(sig, cfg.acq))
    if isinstance(samples, torch.Tensor):
        samples = samples.cpu().numpy()
    search = acquire_fdma if sd.fdma_zero_prn is not None else acquire
    acq_res = search(samples, sig, cfg.acq, device=dev)
    channels = allocate_channels(acq_res, cfg.n_channels, sd=sd,
                                 if_freq=cfg.signal.if_freq)
    stage_s["acquire"] = time.perf_counter() - t0
    if not channels:
        return ReceiverOutput(acq_res, [], None, [], {}, {}, None,
                              stage_s=stage_s)

    t0 = time.perf_counter()
    if sig.signal == "galileo_e1b":
        # Production Galileo tracking is the BOC double-estimator
        # (DLL+SLL, GALILEO/E1/tracking.sci:317-430) — unambiguous,
        # unlike a plain DLL on the composite code; n_ms counts 4 ms
        # code periods for this signal.
        from gnsstpu_torch.tracking.boc import track_boc
        tr = track_boc(source, channels, sig, cfg.track, n_blocks=n_ms,
                       device=dev)
    else:
        tr = track(source, channels, sig, cfg.track, n_ms, device=dev)
    stage_s["track"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    syncs, anchors, ephs, tows, fns = decode_nav(tr, channels, sig)
    nav = navigate_from_anchors(tr, channels, anchors, ephs, sig, cfg.nav,
                                n_ms, fns)
    stage_s["decode_nav"] = time.perf_counter() - t0
    return ReceiverOutput(acq_res, channels, tr, syncs, ephs, tows, nav,
                          anchors=anchors, stage_s=stage_s)


# ---------------------------------------------------------------------------
# Per-constellation nav-message decode (the postNavigation front half:
# findPreambles / findTimeMarks / findSubframeStart / findPageStart +
# the matching ephemeris decoder), normalized into NavAnchor records.
# ---------------------------------------------------------------------------


def _decode_gps(tr, channels, sig, sd):
    syncs: List[FrameSync] = []
    anchors: List[NavAnchor] = []
    ephs: Dict[int, Ephemeris] = {}
    tows: Dict[int, float] = {}
    bit_len = sd.bit_len_codes
    for c, ch in enumerate(channels):
        sync = frame.find_preamble(tr.i_p[c], bit_len)
        syncs.append(sync)
        if not sync.found:
            anchors.append(NavAnchor())
            continue
        bits = frame.bits_from(tr.i_p[c], sync, bit_len)
        eph, tow = lnav.decode_subframes(bits, d30_star=sync.d30_star,
                                 d29_star=sync.d29_star)
        if eph.valid and tow is not None:
            ephs[ch.prn] = eph
            tows[ch.prn] = float(tow)
            anchors.append(NavAnchor(True, sync.first_subframe_ms,
                                     float(tow)))
        else:
            anchors.append(NavAnchor())
    from gnsstpu_torch.nav.ekf import satpos_vel
    from gnsstpu_torch.nav.orbits import satpos
    return syncs, anchors, ephs, tows, (satpos, satpos_vel)


def _decode_glonass(tr, channels, sig, sd):
    """Time-mark anchored string decode (GLONASS/L1/postNavigation.sci:
    findTimeMarks -> string data at +300 ms -> ephemeris strings 1-4;
    the anchor satellite time is tk-referenced, ephemeris.sci:95-97)."""
    from gnsstpu_torch.nav import glonass as gl

    anchors: List[NavAnchor] = []
    ephs: Dict[int, gl.GlonassEphemeris] = {}
    tows: Dict[int, float] = {}
    for c, ch in enumerate(channels):
        tm = gl.find_time_mark(tr.i_p[c])
        if tm < 0:
            anchors.append(NavAnchor())
            continue
        eph, t = gl.decode_strings(tr.i_p[c], tm + 300)
        if eph.valid and t is not None:
            ephs[ch.prn] = eph
            tows[ch.prn] = float(t)
            anchors.append(NavAnchor(True, tm, float(t)))
        else:
            anchors.append(NavAnchor())
    return [], anchors, ephs, tows, (gl.satpos_gl, gl.satpos_vel_gl)


def _decode_beidou(tr, channels, sig, sd):
    from gnsstpu_torch.nav import beidou as bd

    anchors: List[NavAnchor] = []
    ephs: Dict[int, bd.BeiDouEphemeris] = {}
    tows: Dict[int, float] = {}
    for c, ch in enumerate(channels):
        start, _pol = bd.find_subframe(tr.i_p[c])
        if start < 0:
            anchors.append(NavAnchor())
            continue
        eph, t = bd.decode_subframes(tr.i_p[c], start)
        if eph.valid and t is not None:
            ephs[ch.prn] = eph
            tows[ch.prn] = float(t)
            anchors.append(NavAnchor(True, start, float(t)))
        else:
            anchors.append(NavAnchor())
    return [], anchors, ephs, tows, (bd.satpos_bd, bd.satpos_vel_bd)


def _decode_galileo(tr, channels, sig, sd):
    from gnsstpu_torch.nav import galileo as gal

    anchors: List[NavAnchor] = []
    ephs: Dict[int, gal.GalileoEphemeris] = {}
    tows: Dict[int, float] = {}
    prompt = tr.i_pp if hasattr(tr, "i_pp") else tr.i_p  # BOC tracker P/P
    for c, ch in enumerate(channels):
        # Pull-in junk at stream start can fake the 10-symbol sync; the
        # CRC rejects it, so retry from later offsets (one page part
        # = 250 symbols) before giving up.
        anchor = None
        for skip in (0, 250, 500):
            start, _pol = gal.find_page_start(prompt[c, skip:])
            if start < 0:
                continue
            eph, tow = gal.decode_frames(prompt[c, skip:], start)
            if eph.valid and tow is not None:
                anchor = (skip + start, float(tow), eph)
                break
        if anchor is None:
            anchors.append(NavAnchor())
            continue
        idx, tow, eph = anchor
        ephs[ch.prn] = eph
        tows[ch.prn] = tow
        anchors.append(NavAnchor(True, idx, tow))
    return [], anchors, ephs, tows, (gal.satpos_gal, gal.satpos_vel_gal)


_DECODERS = {
    "gps_l1ca": _decode_gps,
    "glonass_l1of": _decode_glonass,
    "glonass_l2of": _decode_glonass,
    "beidou_b1i": _decode_beidou,
    "galileo_e1b": _decode_galileo,
}


def decode_nav(tr, channels, sig):
    """Dispatch the nav-message decode for this signal family.

    Returns (syncs, anchors, ephs, tows, (satpos_fn, satvel_fn)); syncs
    is GPS-only detail (FrameSync records), anchors is uniform.
    """
    sd = get_signal(sig.signal)
    dec = _DECODERS.get(sig.signal)
    if dec is None:
        return [], [NavAnchor() for _ in channels], {}, {}, (None, None)
    return dec(tr, channels, sig, sd)


def navigate_from_anchors(tr, channels, anchors, ephs, sig, nav_cfg, n_ms,
                          fns):
    """Common-epoch alignment + pvt.navigate.

    Channels decode their anchors at different frame positions, so
    t_anchor differs per channel (by whole frame/string periods). Align
    every channel to the latest anchor time T0 by advancing its record
    index ((T0 - t_c) / T_code code periods), then navigate with a single
    common transmit epoch.
    """
    good = [c for c, ch in enumerate(channels)
            if ch.prn in ephs and anchors[c].found]
    if len(good) < 4:
        return None
    period = sig.code_period_s
    t0 = max(anchors[c].t_anchor for c in good)
    sf = [anchors[c].anchor_idx
          + int(round((t0 - anchors[c].t_anchor) / period))
          for c in good]
    return pvt.navigate(
        abs_sample=tr.abs_sample[good],
        prns=[channels[c].prn for c in good],
        subframe_start_ms=sf,
        tow_s=t0,
        ephs=ephs,
        sig=sig,
        nav=nav_cfg,
        n_ms=n_ms,
        carr_freq=tr.carr_freq[good],
        satpos_fn=fns[0], satvel_fn=fns[1],
    )
