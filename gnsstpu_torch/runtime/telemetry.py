"""Typed telemetry stream: the framework's observability bus.

Replaces the reference's binary message telemetry over named pipes/serial
(objects/telemetry.cpp:80-193, message IDs includes/messages.h:37-64) with
typed records serialized as JSON lines to any file-like sink (file, pipe,
socket wrapper) plus optional in-process subscribers. Message families
mirror the reference's: channel health, measurement epochs, PVT solutions,
board/task health, and events (acquisition success/failure, channel drop).

Copied from gnsstpu/runtime/telemetry.py; only the import prefix differs.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, IO, List, Optional

MSG_CHANNEL_HEALTH = "channel_health"     # ≈ CHANNEL_HEALTH_M_ID
MSG_MEASUREMENT = "measurement"           # ≈ MEASUREMENT_M_ID
MSG_PVT = "pvt"                           # ≈ SPS_M_ID / PVT message
MSG_TASK_HEALTH = "task_health"           # ≈ TASK_HEALTH_M_ID
MSG_EVENT = "event"                       # acquisition/drop/watchdog


@dataclasses.dataclass
class Telemetry:
    """JSONL emitter with subscriber fan-out.

    sink: file-like opened in text mode (or None for subscribers-only).
    """

    sink: Optional[IO] = None
    clock: Callable[[], float] = time.time
    subscribers: List[Callable[[dict], None]] = dataclasses.field(
        default_factory=list)
    _count: int = 0

    def subscribe(self, fn: Callable[[dict], None]) -> None:
        self.subscribers.append(fn)

    def emit(self, msg_type: str, **fields) -> dict:
        rec = {"t": self.clock(), "seq": self._count, "type": msg_type,
               **fields}
        self._count += 1
        if self.sink is not None:
            self.sink.write(json.dumps(rec) + "\n")
        for fn in self.subscribers:
            fn(rec)
        return rec

    # --- typed helpers (one per reference message family) ---

    def channel_health(self, epoch_ms: int, chan: int, prn: int,
                       state: str, cn0_dbhz: float, doppler_hz: float,
                       pll_lock: float, **kw) -> None:
        self.emit(MSG_CHANNEL_HEALTH, epoch_ms=epoch_ms, chan=chan,
                  prn=prn, state=state, cn0_dbhz=round(cn0_dbhz, 2),
                  doppler_hz=round(doppler_hz, 2),
                  pll_lock=round(pll_lock, 4), **kw)

    def event(self, epoch_ms: int, what: str, **kw) -> None:
        self.emit(MSG_EVENT, epoch_ms=epoch_ms, what=what, **kw)

    def pvt(self, epoch_ms: int, lat_deg: float, lon_deg: float,
            h_m: float, n_sv: int, **kw) -> None:
        self.emit(MSG_PVT, epoch_ms=epoch_ms, lat_deg=lat_deg,
                  lon_deg=lon_deg, h_m=h_m, n_sv=n_sv, **kw)

    def task_health(self, epoch_ms: int, stage: str, wall_s: float,
                    **kw) -> None:
        self.emit(MSG_TASK_HEALTH, epoch_ms=epoch_ms, stage=stage,
                  wall_s=round(wall_s, 6), **kw)


def read_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
