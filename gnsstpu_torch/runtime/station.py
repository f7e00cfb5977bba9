"""Interactive ground station: live console over telemetry + commands.

The framework's answer to the reference's gps-gse wxWidgets ground
station (gse/src/, 5.8k LoC: live channel plots, PVT view, command path
back into the receiver over /tmp/GUI2GPS — objects/telemetry.cpp:80-89,
objects/commando.cpp). Rebuilt terminal-native:

  * ``GroundStation`` — a HEADLESS interactive core: tails the receiver's
    telemetry JSONL, keeps per-channel C/N0 + I/Q sparkline history,
    renders pages (channels/pvt/health/events), and turns operator
    command lines into CommandBus JSON appended to the command file the
    ChannelManager polls. Fully testable without a TTY.
  * ``run_curses`` — the thin curses wrapper: auto-refresh, number keys /
    TAB switch pages, ``:`` opens the command line, ``q`` quits.

Launched by ``gnsstpu monitor --follow --interactive [--commands F]``.

Copied from gnsstpu/runtime/station.py; only the import prefix differs.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Dict, Optional

from gnsstpu_torch.runtime.console import StatusBoard

SPARK = "▁▂▃▄▅▆▇█"


def sparkline(vals, lo: float, hi: float, width: int = 24) -> str:
    """Unicode mini-chart of the last `width` values."""
    vs = list(vals)[-width:]
    if not vs:
        return ""
    rng = max(hi - lo, 1e-9)
    out = []
    for v in vs:
        t = min(max((v - lo) / rng, 0.0), 1.0)
        out.append(SPARK[int(t * (len(SPARK) - 1))])
    return "".join(out)


class GroundStation:
    """Headless interactive console core (see module docstring)."""

    PAGES = StatusBoard.PAGES

    def __init__(self, log_path: str, command_path: Optional[str] = None,
                 hist: int = 48):
        """log_path: telemetry JSONL file to tail, or a
        ``tcp://host:port`` URL of a receiver-side StationServer
        (runtime.remote) — the reference's named-pipe/serial transport
        split (objects/telemetry.cpp:80-89,193). Over TCP the command
        backhaul rides the same connection; command_path is unused."""
        self.log_path = log_path
        self.command_path = command_path
        self._link = None
        self._tcp = None
        from gnsstpu_torch.runtime.remote import parse_tcp_url
        self._tcp = parse_tcp_url(log_path)
        self.board = StatusBoard()
        self.page_idx = 0
        self.input_mode = False
        self.input_buf = ""
        self.message = (f"keys: 1-{len(self.PAGES)} pages  TAB next  "
                        ": command  q quit")
        self.done = False
        self._pos = 0
        self._hist = hist
        self.cn0_hist: Dict[int, deque] = {}
        self.iq_hist: Dict[int, deque] = {}
        self.dopp_hist: Dict[int, deque] = {}

    # -- telemetry ingestion --

    def _ingest(self, line: str) -> bool:
        """Feed one raw telemetry line into the board/history state."""
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            return False
        self.board.update(rec)
        if rec.get("type") == "channel_health":
            ch = rec["chan"]
            self.cn0_hist.setdefault(
                ch, deque(maxlen=self._hist)).append(
                    rec.get("cn0_dbhz", 0.0))
            self.dopp_hist.setdefault(
                ch, deque(maxlen=self._hist)).append(
                    rec.get("doppler_hz", 0.0))
            ia, qa = rec.get("ip_abs"), rec.get("qp_abs")
            if ia is not None:
                # I/Q balance: |Q|/(|I|+|Q|) ~ 0 when the Costas
                # loop has the signal on I (phase locked).
                bal = qa / max(ia + qa, 1e-9)
                self.iq_hist.setdefault(
                    ch, deque(maxlen=self._hist)).append(bal)
        return True

    def pump(self) -> int:
        """Read any new telemetry lines; returns number consumed."""
        if self._tcp is not None:
            if self._link is None:
                from gnsstpu_torch.runtime.remote import StationSocket
                try:
                    self._link = StationSocket(*self._tcp)
                except OSError:
                    self.message = f"connect failed: {self.log_path}"
                    return 0
            n = sum(1 for line in self._link.read_lines()
                    if self._ingest(line))
            if self._link.closed:
                # Receiver went away (restart, drop): surface it and
                # reconnect on the next pump instead of freezing on
                # stale pages.
                self._link.close()
                self._link = None
                self.message = "station link down — reconnecting"
            return n
        if not os.path.exists(self.log_path):
            return 0
        n = 0
        with open(self.log_path) as f:
            f.seek(self._pos)
            while True:
                line = f.readline()
                if not line or not line.endswith("\n"):
                    break          # EOF or partial line: retry later
                self._pos = f.tell()
                line = line.strip()
                if line and self._ingest(line):
                    n += 1
        return n

    # -- operator input --

    def handle_key(self, key: str) -> None:
        """Feed one key (single char, or 'TAB'/'ENTER'/'BACKSPACE')."""
        if self.input_mode:
            if key == "ENTER":
                self.submit(self.input_buf)
                self.input_buf = ""
                self.input_mode = False
            elif key == "BACKSPACE":
                self.input_buf = self.input_buf[:-1]
            elif key == "ESC":
                self.input_buf = ""
                self.input_mode = False
            elif len(key) == 1 and key.isprintable():
                self.input_buf += key
            return
        if key == ":":
            self.input_mode = True
            self.input_buf = ""
        elif key == "q":
            self.done = True
        elif key == "TAB":
            self.page_idx = (self.page_idx + 1) % len(self.PAGES)
        elif key.isdigit() and 1 <= int(key) <= len(self.PAGES):
            self.page_idx = int(key) - 1

    def submit(self, text: str) -> bool:
        """Parse an operator command line -> CommandBus JSON.

        Grammar (mirrors commando.cpp's command set):
          drop N | mask N | unmask N | set KEY VALUE | stop
        """
        parts = text.split()
        if not parts:
            return False
        cmd = None
        try:
            if parts[0] in ("drop", "mask", "unmask") and len(parts) == 2:
                cmd = {"cmd": parts[0], "prn": int(parts[1])}
            elif parts[0] == "set" and len(parts) == 3:
                cmd = {"cmd": "set", "key": parts[1],
                       "v": float(parts[2])}
            elif parts[0] == "stop" and len(parts) == 1:
                cmd = {"cmd": "stop"}
        except ValueError:
            cmd = None
        if cmd is None:
            self.message = f"?? {text!r} (drop/mask/unmask N, set K V, stop)"
            return False
        if self._tcp is not None:
            # Remote link: the command backhaul rides the telemetry
            # socket (the reference's GUI2GPS reverse pipe role).
            if self._link is None:
                self.message = "not connected"
                return False
            try:
                self._link.send_command(cmd)
            except OSError:
                self.message = "send failed (link down)"
                return False
            self.message = f"sent: {json.dumps(cmd)}"
            return True
        if self.command_path is None:
            self.message = "no command channel (--commands not given)"
            return False
        with open(self.command_path, "a") as f:
            f.write(json.dumps(cmd) + "\n")
        self.message = f"sent: {json.dumps(cmd)}"
        return True

    # -- rendering --

    def render(self, width: int = 100) -> str:
        page = self.PAGES[self.page_idx]
        lines = self.board.render(page).splitlines()
        if page == "channels" and self.cn0_hist:
            lines.append(" ch   C/N0 [25..55 dB-Hz]          "
                         "|Q|/(|I|+|Q|) [0..1]          doppler trend")
            for ch in sorted(self.cn0_hist):
                cn0 = sparkline(self.cn0_hist[ch], 25.0, 55.0)
                iq = sparkline(self.iq_hist.get(ch, []), 0.0, 1.0)
                dh = list(self.dopp_hist.get(ch, []))
                if dh:
                    # Self-scaled window: shows drift/steps, not value.
                    lo, hi = min(dh), max(dh)
                    mid = 0.5 * (lo + hi)
                    half = max(0.5 * (hi - lo), 1.0)
                    dp = sparkline(dh, mid - half, mid + half, 16)
                    dp += f" {dh[-1]:+8.1f}"
                else:
                    dp = ""
                lines.append(f" {ch:2d}   {cn0:<24s}   {iq:<24s}   {dp}")
        if page == "pvt":
            enu = self.board.pvt_enu()
            if len(enu) >= 2:
                e = [x[0] for x in enu]
                n = [x[1] for x in enu]
                u = [x[2] for x in enu]

                def rng(v):
                    mid = 0.5 * (min(v) + max(v))
                    half = max(0.5 * (max(v) - min(v)), 0.5)
                    return mid - half, mid + half

                lines.append(" track (self-scaled):")
                for name, v in (("dE", e), ("dN", n), ("dU", u)):
                    lo, hi = rng(v)
                    lines.append(f"  {name} [{lo:+7.1f}..{hi:+7.1f} m] "
                                 f"{sparkline(v, lo, hi, 40)}")
        if self.input_mode:
            lines.append(f":{self.input_buf}▏")
        else:
            lines.append(f"-- {self.message}")
        return "\n".join(line[:width] for line in lines)


def run_curses(station: GroundStation, interval: float = 0.5) -> int:
    """Curses driver for the station (the live operator surface)."""
    import curses

    def main(scr):
        curses.curs_set(0)
        scr.nodelay(True)
        while not station.done:
            station.pump()
            scr.erase()
            h, w = scr.getmaxyx()
            for y, line in enumerate(
                    station.render(width=w - 1).splitlines()):
                if y >= h - 1:
                    break
                try:
                    scr.addstr(y, 0, line)
                except curses.error:
                    pass
            scr.refresh()
            curses.napms(int(interval * 1000))
            while True:
                ch = scr.getch()
                if ch == -1:
                    break
                if ch in (9,):
                    station.handle_key("TAB")
                elif ch in (10, 13, curses.KEY_ENTER):
                    station.handle_key("ENTER")
                elif ch in (127, 8, curses.KEY_BACKSPACE):
                    station.handle_key("BACKSPACE")
                elif ch == 27:
                    station.handle_key("ESC")
                elif 0 < ch < 256:
                    station.handle_key(chr(ch))

    curses.wrapper(main)
    return 0
