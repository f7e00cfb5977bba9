"""The system under test: gnsstpu_torch's live receiver, built from a
configuration file, fed from sm2 bytes in host memory or on the card, and
watched through its Telemetry bus.

This is the only module of the harness that imports the program. It takes
from it the receiver (ChannelManager + OnlineNavigator), the two packed
sources (through their public constructors) and the telemetry records; everything that judges or times it
lives elsewhere.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from gnsstpu_torch.config import (AcqConfig, NavConfig, ReceiverConfig,
                                  SignalConfig, TrackConfig)
from gnsstpu_torch.ops import track_kernel
from gnsstpu_torch.runtime.manager import ChannelManager
from gnsstpu_torch.runtime.navigator import OnlineNavigator
from gnsstpu_torch.runtime.sources import (DevicePackedArraySource,
                                           PackedArraySource)
from gnsstpu_torch.runtime.telemetry import Telemetry


def receiver_config(cfg: dict, pool) -> ReceiverConfig:
    s = cfg["signal"]
    sig = SignalConfig(signal=s["signal"], if_freq=float(s["if_freq"]),
                       fs=float(s["fs"]), code_freq=float(s["code_freq"]),
                       code_length=int(s["code_length"]),
                       complex_iq=bool(s["complex_iq"]))
    return ReceiverConfig(
        signal=sig, acq=AcqConfig(prn_list=tuple(pool), **cfg["acq"]),
        track=TrackConfig(**cfg["track"]), nav=NavConfig(**cfg["nav"]),
        n_channels=int(cfg["manager"]["n_channels"]))


def build_kernels() -> None:
    """Load (or, in a fresh checkout, compile) the tracking kernels:
    set-up, never inside the window."""
    track_kernel.build_all()


#: The sm2 levels (+-1, +-3) times this scale fall either side of the
#: packer's magnitude threshold (|x| >= 1), so the program's packer gives
#: back the very bytes the levels were decoded from.
SM2_SCALE = 0.5


def packed_source(levels: np.ndarray, packed: np.ndarray, feed: str,
                  device) -> object:
    """The program's packed source over the radio's recording, built
    through its public constructor: levels (f32 [N, 2], the sm2 levels of
    the recording's bytes) packed back to sm2 by the program, in host
    memory for feed 'host' (uploaded per superepoch) or staged on the
    card once for feed 'device'. Raises unless the source serves exactly
    the recording's bytes."""
    if feed == "host":
        src = PackedArraySource(levels, "sm2", scale=SM2_SCALE)
    elif feed == "device":
        src = DevicePackedArraySource(levels, "sm2", scale=SM2_SCALE,
                                      device=device)
    else:
        raise ValueError(f"unknown feed {feed!r}")
    served = src.read_packed(0, len(levels))
    if isinstance(served, torch.Tensor):
        served = served.cpu().numpy()
    if len(src) != len(levels) or not np.array_equal(served, packed):
        raise RuntimeError("the program's packed source does not serve "
                           "the recording's sm2 bytes")
    return src


class StopAt:
    """The manager's command channel: 'stop' once the deadline has
    passed, so the pass in flight ends at its next superepoch."""

    def __init__(self, deadline: float):
        self.deadline = deadline

    def poll(self) -> list:
        return ([{"cmd": "stop"}] if time.perf_counter() >= self.deadline
                else [])


class Watch:
    """The harness's subscriber on the program's Telemetry bus. It stamps
    every record with the host clock; a superepoch is harvested at the
    last record emitted before the next superepoch's first one (its
    'track' task_health) or before the pass ends."""

    def __init__(self, epoch_ms: int):
        self.epoch_ms = epoch_ms
        self.enabled = False
        self.superepochs = []    # (t_harvest, signal ms, pass index)
        self.stages = []         # (t_emit, stage, wall_s)
        self.pass_idx = 0
        self.pass_start = {}     # pass index -> host clock at its start
        self._open = None        # (signal ms) of the superepoch being read
        self._last_t = 0.0
        self.on_stage = None     # called with (stage, wall_s) when set

    def start_pass(self, idx: int) -> None:
        self.pass_idx = idx
        self.pass_start[idx] = time.perf_counter()
        self._open = None

    def end_pass(self) -> None:
        if self._open is not None:
            self.superepochs.append((self._last_t, self._open,
                                     self.pass_idx))
        self._open = None

    def __call__(self, rec: dict) -> None:
        if not self.enabled:
            return
        t = time.perf_counter()
        if rec.get("type") == "task_health":
            stage = rec["stage"]
            if stage == "track":
                if self._open is not None:
                    self.superepochs.append((self._last_t, self._open,
                                             self.pass_idx))
                self._open = rec["sync_every"] * self.epoch_ms
            self.stages.append((t, stage, float(rec["wall_s"])))
            if self.on_stage is not None:
                self.on_stage(stage, float(rec["wall_s"]))
        self._last_t = t


@dataclasses.dataclass
class PassOut:
    """What one pass produced, kept for the check after the window."""

    index: int
    complete: bool
    events: list          # telemetry events of the pass
    history: dict         # the manager's per-PRN prompt history
    decoded: dict         # the navigator's {prn: (anchor, tow, eph)}
    solutions: list       # the navigator's fixes
    signal_ms: int


class Receiver:
    """Builds and runs passes of the configured live receiver over one
    source on one device."""

    def __init__(self, cfg: dict, source, pool, device):
        self.cfg = cfg
        self.source = source
        self.pool = list(pool)
        self.device = torch.device(device)
        self.rcfg = receiver_config(cfg, pool)
        self.watch = Watch(int(cfg["manager"]["epoch_ms"]))
        #: Context around each pass's construction (a profiler span when
        #: the window is traced).
        self.span = contextlib.nullcontext

    def run_pass(self, index: int, n_ms: int,
                 deadline: float = float("inf")) -> PassOut:
        """One cold start over the recording: a fresh manager and
        navigator, run to the end of n_ms or to the first superepoch
        boundary after the deadline."""
        self.watch.start_pass(index)
        events = []
        tlm = Telemetry(sink=None)
        tlm.subscribe(self.watch)
        tlm.subscribe(lambda r: events.append(r)
                      if r.get("type") in ("event", "pvt") else None)
        with self.span("pass_setup"):
            navr, mgr = self._build(tlm, deadline)
        mgr.run(n_ms)
        self.watch.end_pass()
        return PassOut(index=index, complete=mgr.clock_ms >= n_ms,
                       events=events, history=mgr.history,
                       decoded=dict(navr.decoded),
                       solutions=list(navr.solutions),
                       signal_ms=mgr.clock_ms)

    def _build(self, tlm, deadline: float) -> tuple:
        m = self.cfg["manager"]
        navr = OnlineNavigator(self.rcfg.signal, self.rcfg.nav,
                               mode=self.cfg["navigator"]["mode"])
        mgr = ChannelManager(
            self.source, self.rcfg, device=self.device, telemetry=tlm,
            epoch_ms=m["epoch_ms"], reacq_period_ms=m["reacq_period_ms"],
            sync_every=m["sync_every"], navigator=navr, prn_pool=self.pool,
            prefetch=m["prefetch"], readback=m["readback"],
            history_window_ms=m["history_window_ms"], engine=m["engine"],
            commands=StopAt(deadline))
        return navr, mgr


def launches(counter: str) -> int:
    """The program's launch count of a kernel, by its counter's name
    (kernels/<name>.json)."""
    return int(track_kernel.LAUNCHES.get(counter, 0))
