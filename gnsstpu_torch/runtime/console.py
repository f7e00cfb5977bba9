"""Operator console: live status board + runtime command channel.

The reference exposes two operator surfaces the framework mirrors here:

  * a paged console status display of every channel's state
    (osgnss display.c, 218 LoC; the gps-gse wxWidgets channel page,
    gse/src/gui_channel) — rebuilt as ``StatusBoard``, a telemetry
    subscriber that renders a text page from the JSONL stream, usable
    live (subscriber) or offline (``gnsstpu monitor file.jsonl``);
  * a command channel for runtime control (objects/commando.cpp, 592
    LoC: reset/set-parameter commands arriving over the GUI pipe) —
    rebuilt as ``CommandBus``, JSON-line commands polled by the
    ChannelManager at epoch boundaries.

Both speak the same JSONL dialect as the telemetry bus, so a GUI, a
pipe, or a test can drive them identically.

Copied from gnsstpu/runtime/console.py; only the import prefix differs.
"""

from __future__ import annotations

import json
import os
from typing import Dict, IO, List, Optional, Union


def _std(vals) -> float:
    n = len(vals)
    m = sum(vals) / n
    return (sum((v - m) ** 2 for v in vals) / n) ** 0.5


class CommandBus:
    """Poll JSON-line commands from a file/pipe (Commando equivalent).

    Supported commands (one JSON object per line):
      {"cmd": "drop",   "prn": 7}        tear down the channel on PRN 7
      {"cmd": "mask",   "prn": 7}        remove PRN 7 from the acq pool
      {"cmd": "unmask", "prn": 7}        restore PRN 7 to the acq pool
      {"cmd": "set", "key": K, "v": V}   runtime param (reacq_period_ms,
                                         cn0_drop, drop_after, epoch lim)
      {"cmd": "stop"}                    end the run at this epoch
    Unknown commands are reported via telemetry, not fatal (the
    reference ACKs/NAKs over the pipe, commando.cpp).
    """

    def __init__(self, source: Union[str, IO]):
        self._path: Optional[str] = None
        self._fh: Optional[IO] = None
        if isinstance(source, str):
            self._path = source
            self._pos = 0
        else:
            self._fh = source

    def poll(self) -> List[dict]:
        if self._fh is None:
            if self._path is None or not os.path.exists(self._path):
                return []
            with open(self._path) as f:
                f.seek(self._pos)
                text = f.read()
                self._pos = f.tell()
        else:
            text = self._fh.read()
        cmds = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                cmds.append(json.loads(line))
            except json.JSONDecodeError:
                cmds.append({"cmd": "_parse_error", "raw": line[:80]})
        return cmds


class StatusBoard:
    """Channel/PVT status page from telemetry records (display.c twin).

    Feed it records via update() (e.g. Telemetry.subscribe(board.update))
    or a whole JSONL file, then render().
    """

    PAGES = ("channels", "pvt", "ekf", "health", "events", "eph", "alm")

    def __init__(self, n_events: int = 6):
        self.channels: Dict[int, dict] = {}
        self.pvt: Optional[dict] = None
        self.pvt_origin: Optional[dict] = None   # FIRST fix (fixed ENU ref)
        self.pvt_history: List[dict] = []
        self.events: List[dict] = []
        self.stages: Dict[str, dict] = {}     # stage -> {last, max, n, sum}
        self.source: Optional[dict] = None    # stream FIFO counters
        self.ephs: Dict[int, dict] = {}       # prn -> decoded orbit fields
        self.almanac: Optional[dict] = None   # latest almanac_decoded event
        self.ekf: Optional[dict] = None       # latest 'ekf' record
        self.ekf_history: List[dict] = []
        self.visibility: Optional[dict] = None  # latest sv_visibility
        self.n_events = n_events
        self.epoch_ms = 0

    def update(self, rec: dict) -> None:
        t = rec.get("type")
        self.epoch_ms = max(self.epoch_ms, rec.get("epoch_ms", 0) or 0)
        if t == "channel_health":
            self.channels[rec["chan"]] = rec
        elif t == "pvt":
            self.pvt = rec
            if self.pvt_origin is None:
                self.pvt_origin = rec
            self.pvt_history.append(rec)
            del self.pvt_history[:-64]
        elif t == "ekf":
            self.ekf = rec
            self.ekf_history.append(rec)
            del self.ekf_history[:-64]
        elif t == "task_health":
            if rec.get("stage") == "source":
                self.source = rec
            else:
                s = self.stages.setdefault(
                    rec["stage"], {"last": 0.0, "max": 0.0, "n": 0,
                                   "sum": 0.0})
                w = rec["wall_s"]
                s["last"] = w
                s["max"] = max(s["max"], w)
                s["n"] += 1
                s["sum"] += w
        elif t == "event":
            if rec.get("what") == "ephemeris_decoded":
                self.ephs[rec["prn"]] = rec
            elif rec.get("what") == "almanac_decoded":
                self.almanac = rec
            elif rec.get("what") == "sv_visibility":
                self.visibility = rec
            self.events.append(rec)
            if rec.get("what") == "channel_drop":
                ch = self.channels.get(rec.get("chan", -1))
                if ch is not None:
                    ch = dict(ch)
                    ch["state"] = "idle"
                    ch["prn"] = 0
                    self.channels[rec["chan"]] = ch
            del self.events[:-64]

    def render(self, page: str = "channels") -> str:
        """Render one console page. Pages mirror the gse notebook tabs
        (gui_channel / gui_pvt+gui_speedo / gui_health / gui_messages)
        and the osgnss paged display (display.c)."""
        hdr = f"== gnsstpu {page} @ {self.epoch_ms} ms =="
        if page == "pvt":
            return "\n".join([hdr] + self._render_pvt())
        if page == "ekf":
            return "\n".join([hdr] + self._render_ekf())
        if page == "health":
            return "\n".join([hdr] + self._render_health())
        if page == "events":
            return "\n".join([hdr] + self._render_events(24))
        if page == "eph":
            return "\n".join([hdr] + self._render_ephs())
        if page == "alm":
            if self.almanac is None:
                return "\n".join([hdr, " (no almanac decoded yet)"])
            a = self.almanac
            lines = [
                hdr,
                f" entries: {a.get('entries')}",
                f" latest new: {a.get('new')}  from prn "
                f"{a.get('prn_src')} @ {a.get('epoch_ms')} ms",
                f" iono/UTC page: "
                f"{'yes' if a.get('iono_utc') else 'no'}"]
            if self.visibility is not None:
                # Sky view (gse gui_almanac az/el role): from the
                # navigator's almanac+fix predictions.
                lines.append(" prn    az      el   pred.dopp  vis")
                for row in self.visibility.get("sats", []):
                    prn, az, el, dopp, vis = row
                    lines.append(
                        f" {prn:3d}  {az:6.1f}  {el:6.1f}  "
                        f"{dopp:+9.1f}   {'*' if vis else '-'}")
            return "\n".join(lines)
        lines = [hdr, " ch  prn  state      C/N0   doppler    PLL"]
        for chan in sorted(self.channels):
            c = self.channels[chan]
            if c.get("prn"):
                lines.append(
                    f" {chan:2d}  {c['prn']:3d}  {c['state']:<9s}"
                    f"  {c['cn0_dbhz']:5.1f}  {c['doppler_hz']:+8.1f}"
                    f"  {c['pll_lock']:5.2f}")
            else:
                lines.append(f" {chan:2d}    -  idle")
        if self.pvt is not None:
            p = self.pvt
            lines.append(f" pvt: lat {p['lat_deg']:.6f}  lon "
                         f"{p['lon_deg']:.6f}  h {p['h_m']:.1f} m  "
                         f"({p['n_sv']} SV)")
        lines += self._render_events(self.n_events)
        return "\n".join(lines)

    def render_all(self) -> str:
        return "\n\n".join(self.render(p) for p in self.PAGES)

    def pvt_enu(self) -> List[tuple]:
        """Per-fix (dE, dN, dU) meters relative to the FIRST fix of the
        run (fixed origin even after history trims; the gse gui_pvt
        scatter's data)."""
        import math
        if not self.pvt_history:
            return []
        p0 = self.pvt_origin or self.pvt_history[0]
        scale = 111319.5
        clat = math.cos(math.radians(p0["lat_deg"]))
        return [((p["lon_deg"] - p0["lon_deg"]) * scale * clat,
                 (p["lat_deg"] - p0["lat_deg"]) * scale,
                 p["h_m"] - p0["h_m"]) for p in self.pvt_history]

    def _render_pvt(self) -> List[str]:
        if not self.pvt_history:
            return [" (no solutions yet)"]
        enu = self.pvt_enu()
        lines = ["  epoch_ms        lat          lon        h [m]   nSV"
                 "     dE [m]    dN [m]"]
        for p, en in zip(self.pvt_history[-12:], enu[-12:]):
            lines.append(f"  {p.get('epoch_ms', 0):8d}  {p['lat_deg']:11.6f}"
                         f"  {p['lon_deg']:11.6f}  {p['h_m']:8.1f}"
                         f"   {p['n_sv']:3d}  {en[0]:+9.2f} {en[1]:+9.2f}")
        if len(enu) >= 2:
            import math
            e = [x[0] for x in enu]
            n = [x[1] for x in enu]
            lines.append(
                f"  scatter over {len(enu)} fixes: sigmaE "
                f"{_std(e):.2f} m  sigmaN {_std(n):.2f} m  span "
                f"{math.hypot(max(e) - min(e), max(n) - min(n)):.2f} m")
        p = self.pvt
        for k in ("speed_ms", "hdop", "gdop"):
            if k in p:
                lines.append(f"  {k}: {p[k]}")
        return lines

    def _render_ekf(self) -> List[str]:
        """Filtered-navigation view (gse gui_ekf twin): the nav EKF's
        state stream — position, velocity, clock, acceptance."""
        if not self.ekf_history:
            return [" (no EKF solutions yet — run --navigate ekf)"]
        lines = ["  epoch_ms          x            y            z"
                 "      vx     vy     vz   used"]
        for r in self.ekf_history[-12:]:
            lines.append(
                f"  {r.get('epoch_ms', 0):8d}  {r['x']:12.1f} "
                f"{r['y']:12.1f} {r['z']:12.1f}  {r['vx']:6.2f} "
                f"{r['vy']:6.2f} {r['vz']:6.2f}   {r.get('n_used', 0):3d}")
        r = self.ekf
        lines.append(f"  clk {r.get('clk_m', 0.0):.1f} m  drift "
                     f"{r.get('clk_drift_ms', 0.0):.3f} m/s  sigma_pos "
                     f"{r.get('p_pos', 0.0):.2f} m")
        return lines

    def _render_health(self) -> List[str]:
        lines = [" stage       last[ms]   mean[ms]    max[ms]      n"]
        for name in sorted(self.stages):
            s = self.stages[name]
            lines.append(
                f" {name:<10s} {s['last'] * 1e3:9.2f}"
                f"  {s['sum'] / max(s['n'], 1) * 1e3:9.2f}"
                f"  {s['max'] * 1e3:9.2f}  {s['n']:5d}")
        if self.source is not None:
            f = self.source
            lines.append(
                f" fifo: depth {f.get('count', 0)}  pushed "
                f"{f.get('pushed', 0)}  popped {f.get('popped', 0)}  "
                f"overruns {f.get('overruns', 0)}")
        return lines

    def _render_ephs(self) -> List[str]:
        """Decoded-ephemeris browser (gse gui_ephemeris analogue): the
        orbit headline fields each live decode reported."""
        if not self.ephs:
            return [" (no ephemerides decoded yet)"]
        lines = []
        for prn in sorted(self.ephs):
            e = self.ephs[prn]
            kv = {k: e[k] for k in ("sqrtA", "e", "t_oe", "i_0",
                                    "omega_0", "IODnav", "IODC", "x",
                                    "y", "z", "tb", "a_f0", "taun")
                  if k in e}
            pairs = "  ".join(f"{k}={v}" for k, v in kv.items())
            lines.append(f" prn {prn:3d} @ {e.get('epoch_ms', '?')} ms: "
                         f"{pairs}")
        return lines

    def _render_events(self, n: int) -> List[str]:
        lines = []
        for ev in self.events[-n:]:
            kv = {k: v for k, v in ev.items()
                  if k not in ("t", "seq", "type", "what", "epoch_ms")}
            lines.append(f" [{ev.get('epoch_ms', '?')} ms] "
                         f"{ev.get('what')} {kv if kv else ''}".rstrip())
        return lines

    def feed_jsonl(self, path: str) -> None:
        with open(path) as f:
            for line in f:
                if line.strip():
                    self.update(json.loads(line))
