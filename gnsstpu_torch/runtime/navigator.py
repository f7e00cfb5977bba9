"""Online navigator: continuous PVT from live tracking (PVT-thread role).

The reference's real-time receiver navigates continuously — channels
stream bits to the Ephemeris thread and the PVT thread solves at a fixed
cadence (objects/ephemeris.cpp:160-603, objects/pvt.cpp:268 Navigate,
wired by pipes, main/init.cpp). The framework's offline pipeline
(runtime.receiver) decodes and solves after the run; this module is the
LIVE counterpart: polled by the ChannelManager at epoch boundaries, it

  1. watches each tracked PRN's accumulating prompt history, attempts the
     constellation's frame sync + ephemeris decode once enough bits
     exist (retrying on a backoff cadence),
  2. once >= 4 channels have ephemerides + anchors, aligns them to a
     common transmit epoch and runs the LSQ epoch navigator over the
     window tracked so far, emitting each NEW solution as a PVT
     telemetry record (SPS message family, reference messages.h).

Constellations: GPS LNAV, GLONASS strings, BeiDou D1, and Galileo
I/NAV — every family the ChannelManager drives (Galileo E1B rides the
manager through the BocEngine adapter at its 4 ms code period,
tracking.engines; live E1 nav-under-the-manager is pinned by
tests/test_live_families.py).

The port splits each poll into spans on the manager's telemetry
(nav.decode, nav.almanac, nav.solve) and counts decode tries,
ephemerides decoded, epochs solved and fixes emitted on them.

Copied from gnsstpu/runtime/navigator.py, with the port's spans added.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np

from gnsstpu_torch.config import NavConfig, SignalConfig
from gnsstpu_torch.nav import frame, lnav, pvt


def _decode_gps(ip: np.ndarray, bit_len: int):
    sync = frame.find_preamble(ip, bit_len)
    if not sync.found:
        return None
    bits = frame.bits_from(ip, sync, bit_len)
    eph, tow = lnav.decode_subframes(bits, d30_star=sync.d30_star,
                                     d29_star=sync.d29_star)
    if not (eph.valid and tow is not None):
        return None
    return sync.first_subframe_ms, float(tow), eph


def _decode_glonass(ip: np.ndarray, bit_len: int):
    from gnsstpu_torch.nav import glonass as gl

    tm = gl.find_time_mark(ip)
    if tm < 0:
        return None
    eph, t = gl.decode_strings(ip, tm + 300)
    if not (eph.valid and t is not None):
        return None
    return tm, float(t), eph


def _decode_beidou(ip: np.ndarray, bit_len: int):
    from gnsstpu_torch.nav import beidou as bd

    start, _pol = bd.find_subframe(ip)
    if start < 0:
        return None
    eph, t = bd.decode_subframes(ip, start)
    if not (eph.valid and t is not None):
        return None
    return start, float(t), eph


def _decode_galileo(ip: np.ndarray, bit_len: int):
    from gnsstpu_torch.nav import galileo as gal

    # Pull-in junk at the stream head can fake the 10-symbol page sync;
    # the CRC rejects it, so retry past a bogus first hit (same skip
    # ladder as the offline decoder, runtime/receiver._decode_galileo).
    for skip in (0, 250, 500):
        start, _pol = gal.find_page_start(ip[skip:])
        if start < 0:
            continue
        eph, tow = gal.decode_frames(ip[skip:], start)
        if eph.valid and tow is not None:
            return skip + start, float(tow), eph
    return None


def _family(signal: str):
    """(decoder, (satpos_fn, satvel_fn), min stream indexes before the
    first decode attempt). Stream indexes are code periods — 1 ms for
    the 1 ms-code families, 4 ms for Galileo E1."""
    if signal == "gps_l1ca":
        from gnsstpu_torch.nav.ekf import satpos_vel
        from gnsstpu_torch.nav.orbits import satpos
        return _decode_gps, (satpos, satpos_vel), 7000
    if signal in ("glonass_l1of", "glonass_l2of"):
        from gnsstpu_torch.nav import glonass as gl
        return _decode_glonass, (gl.satpos_gl, gl.satpos_vel_gl), 4000
    if signal == "galileo_e1b":
        from gnsstpu_torch.nav import galileo as gal
        # >= ~5 nominal pages (10 s = 2500 blocks) for words 1-5.
        return _decode_galileo, (gal.satpos_gal, gal.satpos_vel_gal), 2600
    if signal == "beidou_b1i":
        from gnsstpu_torch.nav import beidou as bd
        return _decode_beidou, (bd.satpos_bd, bd.satpos_vel_bd), 7000
    return None, (None, None), 0


class OnlineNavigator:
    """Poll-driven live decode + PVT over the ChannelManager's history.

    Attach via ChannelManager(..., navigator=OnlineNavigator(sig, nav)).
    Solutions stream to the manager's telemetry as `pvt` records and
    accumulate in self.solutions ([(epoch_t_ms, NavSolutions-row dict)]).
    """

    def __init__(self, sig: SignalConfig, nav: NavConfig,
                 retry_ms: int = 2000, mode: str = "lsq",
                 ekf_cfg=None, phase_rate: bool = False):
        if mode not in ("lsq", "ekf"):
            raise ValueError(f"mode {mode!r} not in ('lsq', 'ekf')")
        self.sig = sig
        self.nav = nav
        self.retry_ms = retry_ms
        self.mode = mode
        # phase_rate: the EKF's range-rate observation comes from
        # consecutive integrated-carrier-phase latches (delta-phase /
        # dt) instead of the windowed instantaneous Doppler — lower
        # noise once channels are phase-locked, but centered half a
        # solution period back (range-acceleration x lag bias vs the
        # ~50 ms-centered Doppler window); keep sol_period_ms short
        # when enabling it for dynamic platforms.
        self.phase_rate = phase_rate
        self._decode, self._fns, self._min_idx = _family(sig.signal)
        self._period_ms = max(1, int(round(sig.code_period_s * 1e3)))
        self._min_wall_ms = self._min_idx * self._period_ms
        self._warned_unsupported = False
        self.decoded: Dict[int, Tuple[int, float, object]] = {}
        self._next_try: Dict[int, int] = {}
        self._hist_start: Dict[int, int] = {}
        self._next_nav = 0
        self._emitted_t = set()
        # (common_start, good_prns, n_ms) horizon of the previous solve
        # window: everything before it is already solved + emitted, so
        # each poll solves only the newly tracked trailing epochs.
        self._solved_horizon = None
        # Carrier-derived filter state (Hatch smoothing + phase-rate),
        # persistent across polls so the rolling solve window doesn't
        # reset the filters (pvt.navigate(smooth_state=)).
        self._smooth_state: dict = {}
        self.solutions = []
        # EKF mode: seed from the first valid LSQ fix, then fuse each
        # epoch's pseudoranges + Doppler rates; stream filtered PVT as
        # 'ekf' telemetry (the reference's gse gui_ekf feed).
        self._ekf_cfg = ekf_cfg
        self.ekf = None
        self._ekf_fed_t = set()
        self._ekf_last_t: Optional[float] = None
        self.ekf_track = []
        # Live almanac (GPS subframe 4/5 pages; reference Ephemeris
        # thread ephemeris.cpp:425,314) + SV_Select-style warm-start
        # visibility feedback to the manager.
        self.almanac: Dict[int, object] = {}
        self.iono_utc = None
        self._next_alm = 12000
        self.alm_retry_ms = 6000
        # Assist seed (load_assist): rough receiver position + GPS time
        # for pre-fix warm-start visibility (the reference's EEPROM
        # warm start uses a stored position the same way).
        self._seed: Optional[Tuple[np.ndarray, float]] = None

    # -- assist-data persistence (gse gui_eeprom / gui_almanac role) --

    def save_assist(self, path: str) -> None:
        """Dump the decoded almanac + iono/UTC page as JSON (the
        reference GUI's EEPROM/almanac dump, gse gui_eeprom.cxx /
        gui_almanac.cpp, messages EEPROM_M_ID)."""
        import dataclasses as _dc
        import json as _json

        data = {
            "almanac": {int(p): _dc.asdict(a)
                        for p, a in self.almanac.items()},
            "iono_utc": (_dc.asdict(self.iono_utc)
                         if self.iono_utc is not None else None),
        }
        with open(path, "w") as f:
            _json.dump(data, f, indent=1)

    def load_assist(self, path: str, seed_pos=None,
                    seed_t: Optional[float] = None) -> None:
        """Load saved assist data; with a rough position + GPS time
        seed, warm-start visibility predictions run BEFORE the first
        fix (cold-sky search avoided entirely)."""
        import json as _json

        from gnsstpu_torch.nav.almanac import Almanac, IonoUtc

        with open(path) as f:
            data = _json.load(f)
        self.almanac = {int(p): Almanac(**d)
                        for p, d in data.get("almanac", {}).items()}
        iu = data.get("iono_utc")
        if iu is not None:
            self.iono_utc = IonoUtc(**iu)
        if seed_pos is not None and seed_t is not None:
            self._seed = (np.asarray(seed_pos, np.float64),
                          float(seed_t))
            self._next_alm = 0      # predict on the first poll

    # -- called by the manager at epoch boundaries --

    def poll(self, mgr, epoch_ms: int) -> None:
        if self._decode is None:
            # Loud once: a configured signal without live-nav support
            # must not fail silently (GLONASS L3 matches the reference's
            # acq+track-only scope, GLONASS/L3/initSettings.sci).
            if not self._warned_unsupported:
                self._warned_unsupported = True
                mgr.tlm.event(epoch_ms, "live_nav_unsupported",
                              signal=self.sig.signal)
            return
        tlm = mgr.tlm
        with tlm.span("nav.decode", tries=0, ephemerides=0):
            self._try_decodes(mgr, epoch_ms)
        if self.sig.signal == "gps_l1ca":
            with tlm.span("nav.almanac"):
                self._try_almanac(mgr, epoch_ms)
        with tlm.span("nav.solve", epochs=0, fixes=0):
            self._navigate(mgr, epoch_ms)

    def _try_almanac(self, mgr, epoch_ms: int) -> None:
        """Collect broadcast almanac + iono/UTC pages from any synced
        channel's bit stream (Ephemeris-thread role, ephemeris.cpp:425);
        with a position fix, feed SV_Select-style visibility back to the
        manager's acquisition scheduler (sv_select.cpp SV_Predict)."""
        if epoch_ms < self._next_alm:
            return
        self._next_alm = epoch_ms + self.alm_retry_ms
        from gnsstpu_torch.nav import almanac as alm_mod
        from gnsstpu_torch.nav import frame

        bit_len = mgr.sd.bit_len_codes
        for s in mgr.slots:
            if not s.prn:
                continue
            _, ip = self._stream(mgr, s.prn)
            if len(ip) < 4 * 6000:          # >= ~4 subframes of bits
                continue
            sync = frame.find_preamble(ip, bit_len)
            if not sync.found:
                continue
            bits = frame.bits_from(ip, sync, bit_len)
            alms, iu, n_clean = alm_mod.decode_pages(
                bits, d30_star=sync.d30_star, d29_star=sync.d29_star)
            new = sorted(p for p in alms if p not in self.almanac)
            self.almanac.update(alms)
            if iu is not None:
                self.iono_utc = iu
            if new:
                mgr.tlm.event(epoch_ms, "almanac_decoded", prn_src=s.prn,
                              new=new, entries=sorted(self.almanac),
                              iono_utc=self.iono_utc is not None)
            if alms or iu is not None:
                break
            if n_clean >= 2:
                # Stream decodes cleanly — the retained window simply
                # holds no subframe 4/5 page yet. GPS frames are time-
                # synchronous across satellites, so every other
                # channel's window covers the SAME subframes: scanning
                # more slots cannot find pages this poll, it only
                # multiplies the host frame-sync cost by N channels.
                break
            # Frame-synced but nothing passed parity (degraded
            # channel): try the next slot instead of starving almanac
            # collection on slot order.
        # Warm-start visibility: almanac + last fix -> predicted-visible
        # set; the manager masks almanac-known-but-not-visible PRNs out
        # of its searches.
        rx = t = None
        if self.solutions and self.decoded:
            last = self.solutions[-1]
            rx = np.array([last["x"], last["y"], last["z"]])
            # GPS time now ~ anchor TOW + blocks TRACKED SINCE that
            # anchor (adding the full run-elapsed epoch_ms would
            # overestimate time by the anchor channel's own start age —
            # an anchor decoded 50 min into the run carries TOW+50min
            # already). Visibility tolerates tens of seconds of slack.
            ts = []
            for p, (aidx, t_anchor, _e) in self.decoded.items():
                h = mgr.history.get(p)
                if h is None:
                    continue
                n_blk = (h.get("evicted", 0)
                         + sum(len(a) for a in h["i_p"]))
                ts.append(t_anchor
                          + (n_blk - aidx) * self.sig.code_period_s)
            t = max(ts) if ts else None
            if t is None:
                rx = None
        elif self._seed is not None:
            # Pre-fix warm start from loaded assist data (EEPROM role).
            rx = self._seed[0]
            t = self._seed[1] + epoch_ms * 1e-3
        if self.almanac and rx is not None:
            from gnsstpu_torch.nav import visibility

            ephs = {p: a.to_ephemeris() for p, a in self.almanac.items()}
            preds = visibility.predict(
                ephs, t, rx, carrier_hz=mgr.sd.carrier_freq(1),
                mask_deg=self.nav.elevation_mask_deg)
            mgr.warm_visible = {p.prn for p in preds if p.visible}
            mgr.warm_known = set(self.almanac)
            # Sky view for the operator surfaces (gse gui_almanac's
            # az/el display): per-SV az/el/Doppler predictions.
            mgr.tlm.event(
                epoch_ms, "sv_visibility",
                sats=[[p.prn, round(p.az_deg, 1), round(p.el_deg, 1),
                       round(p.doppler_hz, 1), int(p.visible)]
                      for p in preds])

    def _stream(self, mgr, prn: int):
        h = mgr.history[prn]
        ip = np.concatenate(h["i_p"]) if h["i_p"] else np.zeros(0)
        return h, ip

    def _try_decodes(self, mgr, epoch_ms: int) -> None:
        bit_len = mgr.sd.bit_len_codes
        for s in mgr.slots:
            prn = s.prn
            if not prn:
                continue
            # Re-acquired channel: its history restarted (start_ms
            # moved), so the old anchor indexes are meaningless —
            # invalidate and decode afresh.
            start = mgr.history[prn]["start_ms"]
            if self._hist_start.get(prn, start) != start:
                self.decoded.pop(prn, None)
                self._next_try.pop(prn, None)
                # Carrier stream restarted with the channel: the
                # accumulated cycle count reset, so phase-derived
                # filter state is stale.
                for d in self._smooth_state.values():
                    d.pop(prn, None)
            self._hist_start[prn] = start
            if prn in self.decoded:
                continue
            if epoch_ms < self._next_try.get(prn, self._min_wall_ms):
                continue
            self._next_try[prn] = epoch_ms + self.retry_ms
            mgr.tlm.count(tries=1)
            h, ip = self._stream(mgr, prn)
            if len(ip) < self._min_idx:
                continue
            got = self._decode(ip, bit_len)
            if got is None:
                continue
            # Anchor indexes are ABSOLUTE stream positions: decode ran
            # on the retained buffer, which may have evicted its head
            # (manager.history_window_ms bounded-memory mode).
            got = (got[0] + h.get("evicted", 0), got[1], got[2])
            self.decoded[prn] = got
            mgr.tlm.count(ephemerides=1)
            # Headline orbit fields ride the event so operator surfaces
            # (station 'eph' page = gse gui_ephemeris) can browse them.
            eph = got[2]
            fields = {}
            for k in ("sqrtA", "e", "t_oe", "i_0", "omega_0", "IODnav",
                      "IODC", "x", "y", "z", "tb", "a_f0", "taun"):
                v = getattr(eph, k, None)
                if v is not None:
                    fields[k] = round(float(v), 6) if isinstance(
                        v, float) else v
            mgr.tlm.event(epoch_ms, "ephemeris_decoded", prn=prn,
                          anchor_idx=int(got[0]), t_anchor=got[1],
                          **fields)

    def _navigate(self, mgr, epoch_ms: int) -> None:
        if epoch_ms < self._next_nav:
            return
        self._next_nav = epoch_ms + self.nav.sol_period_ms
        live = {s.prn for s in mgr.slots if s.prn}
        good = [p for p in sorted(self.decoded) if p in live]
        if len(good) < 4:
            return
        # Only the history dicts are needed here (the prompt-stream
        # concat _stream() performs is for the decoders, and is O(full
        # retained window) per channel — pure waste per solve poll).
        streams = {p: (mgr.history[p], None) for p in good}
        # Channels acquired at different epochs have offset stream
        # origins; align every stream to the latest channel start so
        # record index k means the same receive epoch on all rows.
        start = {p: streams[p][0]["start_ms"] for p in good}
        common = max(start.values())
        # Stream indexes are CODE PERIODS (4 ms for Galileo E1), while
        # start_ms is wall milliseconds.
        off = {p: (common - start[p]) // self._period_ms for p in good}
        # Retained-buffer geometry in ALIGNED indexes: channel data
        # exists for aligned k with k + off[p] in
        # [evicted_p, evicted_p + buflen_p) (bounded-memory mode evicts
        # stream heads; h['evicted'] keeps indexing absolute).
        ev = {p: streams[p][0].get("evicted", 0) for p in good}
        n_ms = min(ev[p] + sum(len(a)
                               for a in streams[p][0]["abs_sample"])
                   - off[p] for p in good)
        k_lo = max([0] + [ev[p] - off[p] for p in good])
        period = self.sig.code_period_s
        step_p = max(1, int(round(self.nav.sol_period_ms * 1e-3
                                  / period)))
        # Rolling solve window: only the trailing epochs need solving
        # (earlier ones were solved by previous polls; _emitted_t
        # dedupes); this keeps per-poll cost constant over a long run.
        k_lo = max(k_lo, n_ms - 8 * step_p)
        # Incremental horizon: epochs before the PREVIOUS poll's n_ms
        # were already solved (and any re-emission is deduped anyway),
        # so re-solving them is pure waste — measured ~7 redundant LSQ
        # epochs per poll in the r5 bench. One step of overlap keeps
        # the emitted solution grid seamless. The horizon only applies
        # while the solve WORLD is unchanged — same alignment base AND
        # same satellite set; slot churn or a newly decoded SV falls
        # back to the full trailing window (it can rewrite n_ms/common
        # arbitrarily). The horizon is recorded just before the solve
        # actually runs, never on an early return.
        if self._solved_horizon is not None:
            h_common, h_good, h_n = self._solved_horizon
            if h_common == common and h_good == tuple(good):
                if h_n >= n_ms:
                    return          # nothing new tracked since last solve
                # Two steps of overlap: pvt.navigate floors the epoch
                # grid, so with one step the last in-window grid epoch
                # (leftover-plus-anchor-spread past the floor) could
                # fall between consecutive windows and never be solved.
                k_lo = max(k_lo, h_n - 2 * step_p)
        if n_ms - k_lo <= 0:
            return
        # Per channel: transmit time of the code start at ALIGNED index 0
        # (t_anchor refers to own-stream index anchor = aligned index
        # anchor - off). The common epoch t0 = latest of these puts every
        # anchor index sf >= 0 (navigate_from_anchors alignment, live).
        t00 = {p: self.decoded[p][1]
               - (self.decoded[p][0] - off[p]) * period for p in good}
        t0 = max(t00.values())
        sf = np.array([int(round((t0 - t00[p]) / period))
                       for p in good])
        # Rebase the window origin to k_lo: advance every anchor by
        # whole solution steps so sf stays >= 0 inside the window, and
        # remember the shift to report t_ms in the aligned-stream base.
        if k_lo > 0:
            k0 = max(0, int(max(np.ceil((k_lo - sf) / step_p))))
            sf_w = sf + k0 * step_p - k_lo
            tow_w = t0 + k0 * step_p * period
        else:
            k0 = 0
            sf_w = sf
            tow_w = t0
        n_w = n_ms - k_lo
        if int(sf_w.max()) >= n_w:
            return
        self._solved_horizon = (common, tuple(good), n_ms)
        t_shift_ms = k_lo * period * 1e3

        def lane(p, key):
            h, _ = streams[p]
            a = np.concatenate(h[key])
            return a[k_lo + off[p] - ev[p]: n_ms + off[p] - ev[p]]

        abs_sample = np.stack([lane(p, "abs_sample") for p in good])
        ephs = {p: self.decoded[p][2] for p in good}
        ekf_kw = {}
        # Lanes must be NON-EMPTY to stack ("in" is vacuous: the
        # manager always creates the carr_cycles key).
        have_carr = all(streams[p][0]["carr_cycles"] for p in good)
        if self.nav.carrier_smoothing_s > 0 and have_carr:
            # Hatch smoothing needs the carrier stream in LSQ mode too.
            ekf_kw["carr_cycles"] = np.stack(
                [lane(p, "carr_cycles") for p in good])
            ekf_kw["smooth_state"] = self._smooth_state
        if self.mode == "ekf":
            from gnsstpu_torch.signals.registry import get_signal

            sd = get_signal(self.sig.signal)
            fdma_off = np.zeros(len(good))
            if sd.fdma_zero_prn is not None:
                fdma_off = np.array(
                    [sd.carrier_freq(p)
                     - sd.carrier_freq(sd.fdma_zero_prn) for p in good])
            carr = np.stack([lane(p, "carr_doppler") for p in good])
            carr += (self.sig.if_freq + fdma_off[:, None])
            # Additive: a dict REASSIGNMENT here silently discarded the
            # Hatch block above in EKF mode.
            ekf_kw["carr_freq"] = carr
            ekf_kw["collect_meas"] = True
            if "carr_cycles" not in ekf_kw and have_carr:
                ekf_kw["carr_cycles"] = np.stack(
                    [lane(p, "carr_cycles") for p in good])
                ekf_kw["smooth_state"] = self._smooth_state
        if self.nav.use_iono and self.iono_utc is not None:
            ekf_kw["iono"] = self.iono_utc
        sol = pvt.navigate(
            abs_sample=abs_sample, prns=good,
            subframe_start_ms=list(sf_w),
            tow_s=tow_w, ephs=ephs, sig=self.sig, nav=self.nav,
            n_ms=n_w,
            satpos_fn=self._fns[0], satvel_fn=self._fns[1], **ekf_kw)
        sol.t_ms += t_shift_ms
        mgr.tlm.count(epochs=len(sol.t_ms))
        for m in sol.meas:
            m["t_ms"] += t_shift_ms
        # Port: every epoch in the manager's clock (common + t_ms, the
        # absolute stream time), so that a channel joining or restarting,
        # which moves `common`, never sends the fixes' t_ms (pvt records,
        # self.solutions, the EKF's dt) back in time. key_of's absolute
        # time is then t_ms itself.
        sol.t_ms += common
        for m in sol.meas:
            m["t_ms"] += common
        common = 0

        # Dedup keys must be ALIGNMENT-INDEPENDENT: t_ms is relative to
        # the common start, which rebases when the satellite set
        # changes (re-emitting already-solved epochs, double-fusing the
        # EKF). common + t_ms is absolute stream time; rounding kills
        # the ~1e-12 ms float residue different k_lo splits introduce.
        def key_of(t_ms_val: float) -> float:
            return round(common + float(t_ms_val), 6)

        if self.mode == "ekf":
            self._feed_ekf(mgr, sol, key_of)
        for k in range(len(sol.t_ms)):
            if not sol.valid[k] or key_of(sol.t_ms[k]) in self._emitted_t:
                continue
            self._emitted_t.add(key_of(sol.t_ms[k]))
            mgr.tlm.count(fixes=1)
            mgr.tlm.pvt(int(sol.t_ms[k]), float(sol.latitude[k]),
                        float(sol.longitude[k]), float(sol.height[k]),
                        int(sol.n_sats[k]),
                        gdop=round(float(sol.dop[k, 0]), 2),
                        hdop=round(float(sol.dop[k, 2]), 2),
                        x=round(float(sol.x[k]), 2),
                        y=round(float(sol.y[k]), 2),
                        z=round(float(sol.z[k]), 2))
            self.solutions.append({
                "t_ms": float(sol.t_ms[k]), "x": float(sol.x[k]),
                "y": float(sol.y[k]), "z": float(sol.z[k]),
                "lat": float(sol.latitude[k]),
                "lon": float(sol.longitude[k]),
                "h": float(sol.height[k]), "n_sv": int(sol.n_sats[k])})
        self._prune()

    # Trailing retention of the navigator's per-epoch products: the
    # manager bounds its history/records for multi-day live runs
    # (history_window_ms); the solution/track lists and dedup key sets
    # must not regrow that memory linearly. 20k solutions = ~5.5 h at
    # 1 Hz; every solution also went out as telemetry, so trimming the
    # head loses nothing an operator/analyst could not log.
    _MAX_KEEP = 20_000

    def _prune(self) -> None:
        if len(self.solutions) > self._MAX_KEEP:
            del self.solutions[: len(self.solutions) - self._MAX_KEEP]
        if len(self.ekf_track) > self._MAX_KEEP:
            del self.ekf_track[: len(self.ekf_track) - self._MAX_KEEP]
        for keys in (self._emitted_t, self._ekf_fed_t):
            if len(keys) > 4 * self._MAX_KEEP:
                keep = sorted(keys)[-2 * self._MAX_KEEP:]
                keys.clear()
                keys.update(keep)

    def _feed_ekf(self, mgr, sol, key_of) -> None:
        """Fuse the window's NEW measurement epochs into the nav EKF and
        stream filtered PVT ('ekf' record family; gse gui_ekf feed).
        key_of maps a window t_ms to its alignment-independent dedup
        key (see _navigate)."""
        from gnsstpu_torch.nav.ekf import EkfConfig, NavEkf

        for m in sol.meas:
            t = m["t_ms"]
            if key_of(t) in self._ekf_fed_t:
                continue
            self._ekf_fed_t.add(key_of(t))
            if self.ekf is None:
                # Seed from the matching LSQ epoch (first valid fix).
                k = int(np.argmin(np.abs(sol.t_ms - t)))
                if not sol.valid[k]:
                    continue
                x0 = np.array([sol.x[k], sol.y[k], sol.z[k],
                               0.0, 0.0, 0.0, sol.dt[k], 0.0])
                self.ekf = NavEkf(
                    x0, self._ekf_cfg or EkfConfig(
                        use_tropo=self.nav.use_tropo))
                self._ekf_last_t = t
                continue
            dt = max((t - self._ekf_last_t) * 1e-3, 0.0)
            self._ekf_last_t = t
            prr = m.get("prr")
            if self.phase_rate and m.get("prr_phase") is not None:
                pp = np.asarray(m["prr_phase"])
                # Channels without two phase latches yet fall back to
                # the Doppler-derived range rate.
                prr = pp if prr is None else np.where(
                    np.isfinite(pp), pp, prr)
            st = self.ekf.step(dt, m["sat_pos"], m["obs"],
                               m.get("sat_vel"), prr)
            rec = {
                "t_ms": t, "x": float(st.pos[0]), "y": float(st.pos[1]),
                "z": float(st.pos[2]), "vx": float(st.vel[0]),
                "vy": float(st.vel[1]), "vz": float(st.vel[2]),
                "clk_m": st.clock_bias_m, "clk_drift_ms": st.clock_drift_ms,
                "n_used": int(st.accepted.sum()),
                "p_pos": round(float(np.sqrt(
                    np.trace(self.ekf.P[:3, :3]))), 3),
            }
            self.ekf_track.append(rec)
            mgr.tlm.emit("ekf", epoch_ms=int(t),
                         **{k: (round(v, 3) if isinstance(v, float)
                                else v) for k, v in rec.items()
                            if k != "t_ms"})
