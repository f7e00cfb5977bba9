"""Typed telemetry stream: the framework's observability bus.

Replaces the reference's binary message telemetry over named pipes/serial
(objects/telemetry.cpp:80-193, message IDs includes/messages.h:37-64) with
typed records serialized as JSON lines to any file-like sink (file, pipe,
socket wrapper) plus optional in-process subscribers. Message families
mirror the reference's: channel health, measurement epochs, PVT solutions,
board/task health, and events (acquisition success/failure, channel drop).

The port adds spans: Telemetry.span times a phase of the program (the
task_health walls come from it). With trace=True each span is also kept
in memory as a record (Telemetry.spans) and, where it nests on its
thread, entered as a torch.profiler range named gnss.<name>, so a
profile's device timeline and the program's phases share one clock.

Copied from gnsstpu/runtime/telemetry.py, with the port's spans added.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
from typing import Callable, IO, List, Optional

MSG_CHANNEL_HEALTH = "channel_health"     # ≈ CHANNEL_HEALTH_M_ID
MSG_MEASUREMENT = "measurement"           # ≈ MEASUREMENT_M_ID
MSG_PVT = "pvt"                           # ≈ SPS_M_ID / PVT message
MSG_TASK_HEALTH = "task_health"           # ≈ TASK_HEALTH_M_ID
MSG_EVENT = "event"                       # acquisition/drop/watchdog

#: Prefix of the profiler ranges that spans enter.
RANGE_PREFIX = "gnss."


class _Wall:
    """A phase timed on the host's clock (perf_counter_ns): what a span
    is with tracing off. Counters given to it are dropped."""

    __slots__ = ("t0_ns", "t1_ns")

    def __enter__(self):
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1_ns = time.perf_counter_ns()

    @property
    def wall_s(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9


class _Span(_Wall):
    """A phase kept as a record when it ends. nest: pushed on its
    thread's stack (the parent of spans opened inside it) and entered as
    a profiler range; a span that crosses loop iterations does neither."""

    __slots__ = ("tlm", "name", "se", "counters", "id", "parent", "nest",
                 "_range")

    def __init__(self, tlm: "Telemetry", name: str, se, counters: dict,
                 nest: bool):
        self.tlm = tlm
        self.name = name
        self.se = se
        self.counters = counters
        self.nest = nest
        self.id = next(tlm._ids)
        self.parent = None
        self._range = None

    def __enter__(self):
        self.t0_ns = time.perf_counter_ns()
        if self.nest:
            stack = self.tlm._stack()
            if stack:
                self.parent = stack[-1].id
                if self.se is None:
                    self.se = stack[-1].se
            stack.append(self)
            self._range = self.tlm._record_function(RANGE_PREFIX + self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.nest:
            self._range.__exit__(*exc)
            self.tlm._stack().pop()
        self.t1_ns = time.perf_counter_ns()
        self.tlm._records.append({
            "name": self.name, "id": self.id, "parent": self.parent,
            "se": self.se, "thread": threading.current_thread().name,
            "t0_ns": self.t0_ns, "t1_ns": self.t1_ns,
            "counters": self.counters})


@dataclasses.dataclass
class Telemetry:
    """JSONL emitter with subscriber fan-out.

    sink: file-like opened in text mode (or None for subscribers-only).
    trace: keep every span as a record and enter the nesting ones as
      profiler ranges (off: spans only time their bodies).
    """

    sink: Optional[IO] = None
    clock: Callable[[], float] = time.time
    subscribers: List[Callable[[dict], None]] = dataclasses.field(
        default_factory=list)
    _count: int = 0
    trace: bool = False
    _records: list = dataclasses.field(default_factory=list, init=False,
                                       repr=False)

    def __post_init__(self) -> None:
        if self.trace:
            from torch.profiler import record_function

            self._record_function = record_function
            self._ids = itertools.count(1)
            self._local = threading.local()

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

    # --- spans (the port's) ---

    def span(self, name: str, se=None, **counters):
        """Context manager timing a phase; its wall_s holds the seconds
        once it ends. se: the key of the superepoch the phase serves (the
        epoch_ms of its first epoch; by default the enclosing span's).
        counters: numbers kept on the record (Telemetry.count adds)."""
        if not self.trace:
            return _Wall()
        return _Span(self, name, se, counters, nest=True)

    def open_span(self, name: str, se=None, **counters):
        """Start a span that ends in another loop iteration
        (close_span): a record only, with no profiler range."""
        sp = _Span(self, name, se, counters, nest=False) if self.trace \
            else _Wall()
        return sp.__enter__()

    def close_span(self, sp, **counters) -> None:
        if self.trace:
            sp.counters.update(counters)
        sp.__exit__(None, None, None)

    def count(self, **counters) -> None:
        """Add to the counters of the innermost span open on this
        thread."""
        if not self.trace:
            return
        stack = self._stack()
        if stack:
            c = stack[-1].counters
            for k, v in counters.items():
                c[k] = c.get(k, 0) + v

    @property
    def spans(self) -> List[dict]:
        """The ended spans' records, in the order they ended. A span with
        no enclosing span on its thread has the superepoch span of its
        se as parent, where that superepoch was dispatched."""
        se_ids = {r["se"]: r["id"] for r in self._records
                  if r["name"] == "superepoch"}
        for r in self._records:
            if r["parent"] is None and r["name"] != "superepoch":
                r["parent"] = se_ids.get(r["se"])
        return list(self._records)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

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
