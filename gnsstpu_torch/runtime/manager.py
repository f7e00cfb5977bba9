"""Channel manager: acquisition scheduling, lock supervision, reacquisition
(port of gnsstpu/runtime/manager.py for every signal family, on one
device or sharded over a device mesh).

The device tracks a fixed [C]-slot channel bank; the host supervises at
epoch boundaries: it reads back prompt statistics, assesses lock, swaps
PRNs in and out of slots, and emits telemetry. The host supervision (slot
life cycle with CONFIRM probation, _supervise_epoch/_supervise_block,
history trimming, runtime commands, watchdog and stall recovery,
prompt_stream) is the reference's, copied, and family-agnostic: the
tracking engine (tracking.engines: K1 for the 1 ms codes, K2 for E1B's
4 ms blocks, K3 for L3OC's pilot + data) hands it the same per-block
observables; a dual-component engine adds the data prompts, which ride two
more stream lanes into the i_p2 / q_p2 history. The device parts
are torch: slot rows are written in place, a superepoch is a Python loop
of k kernel launches each followed by its device lock summary (one
launch of ops.summary_kernel's kernel, which writes the epoch's slot of
the superepoch's readback buffer), and the readback is one host copy per
superepoch.

A superepoch (sync_every epochs) is one upload + k dispatches + one
readback, and each of its steps is written once; two drivers call them.
The serial one rebases every slot row from the host and supervises each
superepoch before the next. With prefetch=True and sync_every > 1 the
pipeline lets the device run free: a reader thread reads and uploads
chunk n+1 while chunk n runs and the host supervises chunk n-1 (one more
superepoch of decision lag); the rows carry across superepochs, shifted
by the base delta, and slots placed by a supervision start one
superepoch later. readback='compact' ships the per-block observables as one byte-packed
buffer (f16 prompts, pilot and data for L3OC, u16 rem, i16 blksize delta,
f32 Doppler + stats). A chunk read into host memory crosses to a card
through pinned staging on a CUDA stream of the feed's own
(runtime.feed_stage), and the dispatch's stream waits for it on the card.

Acquisition is FFT search over a grid built in one place (_acq_grid): the
all-PRN code bank against a Doppler grid (CDMA), or one shared code row
against the flattened [frequency channel x Doppler] carrier grid (GLONASS
L1/L2 OF, FDMA). A due search rides the superepoch's uploaded chunk; on a
CDMA bank it correlates only the code rows of the PRNs it is for
(bank_rows). A noncoherent ('sum') search longer than one chunk
accumulates its whole-bank power cube on the device across consecutive
chunks (the weak tier). The live channel bank saves to and restores from
a checkpoint file (the reference's npz + JSON format) for a warm restart
without reacquisition.

With a mesh (parallel.make_mesh), the slot bank's channel rows and the
tracking state are split over mesh["channel"]: slot i lives on shard
i // (C / N), each superepoch epoch runs the engine's step on every shard
(K1 once per shard), and the per-block observables are assembled along C
on the mesh's first device, where the lock summary, the readback, the
on-chunk search and the weak tier run as without a mesh. Records and
prompt streams are bit-identical to the unsharded manager's.

Every host phase is a span on the telemetry (Telemetry.span), keyed by
its superepoch (se: the epoch_ms of its first epoch), and the task_health
walls are the spans' walls. The supervision thread: superepoch (dispatch
to the end of its supervision, a record only), feed.wait, dispatch (with
acq.chunk_search), harvest.wait (pipelined) or readback, supervise (per
epoch nav.poll, history.trim), acq.finish, acq.host_search, and
manager.build in the constructor; the reader thread (gnss-feed):
feed.read, feed.upload; the fetch thread (gnss-fetch):
fetch.device_wait, fetch.decode. With tracing on, K1's and K3's
launches carry CUDA timing events, summed into the superepoch span's
k1_device_ns / k3_device_ns (with k1_launches / k3_launches), the
dispatch span counts the summary kernel's launches (summaries), the
feed.upload span the samples the wire table decoded (decoded; 0 for f32
samples) beside the bytes read into host memory (bytes), the bytes of
those that crossed to the card through the pinned staging ring (staged)
and the host's waits for a ring slot still in flight (stage_waits), and
each search span (acq.host_search, acq.chunk_search) the code rows it
correlated (codes) and whether pilot and data powers were summed
(combined).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from gnsstpu_torch.config import ReceiverConfig, SignalConfig
from gnsstpu_torch.runtime.telemetry import Telemetry
from gnsstpu_torch.signals.registry import get_signal
from gnsstpu_torch.acquisition.search import (
    AcqResults, _windows_of, acq_samples_needed, acquire, acquire_fdma,
    bank_rows, code_fd_tensor, combine_components, fdma_grid,
    fine_doppler_ms, refine_doppler)
from gnsstpu_torch.device import U32_MASK, resolve_device
from gnsstpu_torch.ops import fft_acquire, summary_kernel, track_kernel
from gnsstpu_torch.ops import unpack as up
from gnsstpu_torch.parallel.mesh import (Sharded, replicate, shard_rows,
                                         to_device, tree_map)
from gnsstpu_torch.runtime import feed_stage
from gnsstpu_torch.tracking import lock as tlock
from gnsstpu_torch.tracking.engines import make_engine

class SlotState(enum.Enum):
    IDLE = "idle"
    # Post-acquisition probation: lock on confirm_m of the first
    # confirm_epochs supervision epochs, or the slot is dropped.
    CONFIRM = "confirm"
    TRACKING = "tracking"


@dataclasses.dataclass
class Slot:
    state: SlotState = SlotState.IDLE
    prn: int = 0
    bad_epochs: int = 0
    started_ms: int = 0
    confirm_good: int = 0
    confirm_seen: int = 0


@dataclasses.dataclass
class EpochRecord:
    """Per-epoch per-slot observables kept by the manager."""

    epoch_ms: int
    prn: np.ndarray           # [C] (0 = idle)
    cn0_dbhz: np.ndarray      # [C]
    pll_lock: np.ndarray      # [C]
    doppler_hz: np.ndarray    # [C]


class _Readback:
    """A device->host copy in flight: pinned host tensors filled with
    non_blocking copies and a CUDA event recorded behind them (the
    counterpart of jax copy_to_host_async); on the CPU, the tensors."""

    def __init__(self, tensors):
        self._event = None
        if tensors and tensors[0].device.type == "cuda":
            host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                host.append(h)
            self._event = torch.cuda.Event()
            self._event.record()
            tensors = host
        self._tensors = tensors

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()

    def numpy(self) -> list:
        self.wait()
        return [t.numpy() for t in self._tensors]


@dataclasses.dataclass
class _Inflight:
    """A dispatched, not yet supervised superepoch of either driver: what
    the dispatch issued and the spans that timed it. The serial driver
    supervises it at once; the pipeline one superepoch later, its
    readback decoded on the fetch thread (fetch)."""

    e0: int
    k: int
    base: int
    packed: _Readback
    acq_fut: Optional[_Readback]
    acq_want: list
    acq_host: bool
    buf: object
    n_active: int
    read: object              # spans: the chunk's read and upload,
    upload: object
    dispatch: object          # the dispatch,
    span: object              # the superepoch (open until supervised)
    kernel_events: Optional[list] = None  # K1 / K3 timing (tracing on)
    fetch: object = None
    acq_base: int = 0


@dataclasses.dataclass
class _Chunk:
    """A prefetched superepoch chunk (host buffer + device upload)."""

    base: int
    k: int
    buf: object
    dev: object               # device f32 [chunk_len, 2] or None if ended
    ended: bool
    need_len: int
    read: object              # spans of the read and the upload
    upload: object
    ready: object             # event dev's readers wait on, or None


#: Bank arrays from this size up are uploaded through pinned memory
#: (_put_dev): K3's tap tables, 11.5 MB a channel at 24 Msps (139 MB a
#: 12-channel bank, uploaded at each cold start); K1's whole bank at
#: 2.048 Msps is 3.3 MB and stays pageable.
_PINNED_BYTES = 8 << 20


def _host_bytes(buf) -> int:
    """Bytes of a chunk read into host memory (0 for one the source
    already holds on the device)."""
    if isinstance(buf, torch.Tensor):
        return buf.nbytes if buf.device.type == "cpu" else 0
    return np.asarray(buf).nbytes


def _rows_map(state, fn):
    """fn(part, rows) on every shard of a Sharded state (rows: the slot
    indices the part holds), or fn(state, slice(None)) on a whole one."""
    if isinstance(state, Sharded):
        return state.map(fn)
    return fn(state, slice(None))


def _drift_margin(sig: SignalConfig, epoch_ms: int, sync_every: int,
                  prefetch: bool, spread_budget_s: float) -> int:
    """Window slack: per-superepoch code-Doppler drift plus the
    inter-channel code-phase spread a live session accumulates (as the
    reference manager budgets it)."""
    lag = 2 if prefetch else 1
    return 64 + sig.samples_per_code + int(np.ceil(
        lag * sync_every * epoch_ms * 1e-3 * 2e-5 * sig.fs
        + spread_budget_s * 6.4e-6 * sig.fs))


class ChannelManager:
    """Supervises a fixed bank of tracking slots over a sample source.

    device: where the slot bank, tracking state and sample chunks live
      ('cuda', the default, for the card, which raises on a host
      without one; 'cpu' runs the kernels' plain twins).
    sync_every: supervision epochs per device round trip (superepoch).
    wire: host->device sample wire format — 'auto' uses
      source.wire_format when the source provides read_packed().
    engine: 'auto' (= 'fused': kernel K1, K2 for Galileo E1B, K3 for
      GLONASS L3OC), 'fused', 'gather', 'table' (the exact scan engines).
    mesh: a parallel.mesh.Mesh of this process's devices (its first
      device's type must be `device`'s): the slot bank and tracking state
      split over mesh["channel"], whose size must divide n_channels; the
      engine's kernel (K1, K2 or K3) launches once per shard.
    """

    def __init__(self, source, cfg: ReceiverConfig, *, device="cuda",
                 telemetry: Optional[Telemetry] = None,
                 epoch_ms: int = 100, drop_after_epochs: int = 3,
                 reacq_period_ms: int = 500,
                 cn0_drop_dbhz: float = 32.0,
                 prn_pool: Optional[List[int]] = None,
                 stall_timeout_s: float = 30.0,
                 confirm_epochs: int = 3, confirm_m: int = 2,
                 commands=None, engine: str = "auto", navigator=None,
                 sync_every: int = 1, wire: str = "auto",
                 spread_budget_s: float = 900.0,
                 prefetch: bool = False, readback: str = "f32",
                 history_window_ms: Optional[int] = None, mesh=None):
        self.device = resolve_device(device)
        C = cfg.n_channels
        self.mesh = mesh
        if mesh is not None:
            n = mesh.shape.get("channel")
            if n is None:
                raise ValueError("mesh has no axis 'channel'")
            if C % n:
                raise ValueError(
                    f"n_channels {C} not divisible by mesh axis "
                    f"'channel' size {n}")
            if mesh.distributed:
                raise ValueError("the manager takes a mesh of make_mesh, "
                                 "not of make_distributed_mesh")
            if mesh.first_device.type != self.device.type:
                raise ValueError(f"mesh on {mesh.first_device}, device "
                                 f"{self.device}")
            self.device = mesh.first_device
        self.source = source
        self.cfg = cfg
        self.sig = cfg.signal
        self.sd = get_signal(self.sig.signal)
        self.tlm = telemetry or Telemetry()
        self.epoch_ms = epoch_ms
        self.drop_after = drop_after_epochs
        self.reacq_period_ms = reacq_period_ms
        self.cn0_drop = cn0_drop_dbhz
        self.pool = list(prn_pool if prn_pool is not None
                         else range(1, self.sd.num_prn + 1))
        self.stall_timeout_s = stall_timeout_s
        self.confirm_epochs = confirm_epochs
        self.confirm_m = confirm_m
        self.commands = commands
        self.navigator = navigator
        self.sync_every = max(1, int(sync_every))
        self.prefetch = bool(prefetch)
        if readback not in ("f32", "compact"):
            raise ValueError(f"readback {readback!r}")
        self.readback = readback
        self._src_lock = threading.Lock()
        self._alloc_log: Optional[list] = None
        self._chunk_cache = None        # (base, host buf) of last chunk
        self._consec_restarts = 0
        self._stop = False
        # Navigator warm start: predicted-visible PRNs from a decoded
        # almanac + fix; searches skip almanac-known PRNs below the mask.
        self.warm_visible: Optional[set] = None
        self.warm_known: set = set()

        with self.tlm.span("manager.build"):
            if wire == "auto":
                wire = (getattr(source, "wire_format", None)
                        if hasattr(source, "read_packed") else None)
            self.wire = wire                   # None = plain array reads

            self.slots = [Slot() for _ in range(C)]
            spc = self.sig.samples_per_code
            self.eng = make_engine(cfg, engine, mesh=mesh)
            self.engine = self.eng.name
            if epoch_ms % self.eng.period_ms:
                raise ValueError(
                    f"epoch_ms {epoch_ms} not a multiple of the signal's "
                    f"code period {self.eng.period_ms} ms")
            self._bpe = epoch_ms // self.eng.period_ms   # blocks per epoch
            self._bank = self.eng.new_bank(C)
            self._state = self._shard(self.eng.init_state(C, self.device))
            self._bank_dev = None
            self._abs_pos = np.zeros(C, np.float64)  # per-slot next sample
            self._cursor = 0                         # epoch base sample
            self._next_reacq_ms = 0
            self._clock_epochs = 0
            self._drift_margin = _drift_margin(
                self.sig, epoch_ms, self.sync_every, self.prefetch,
                spread_budget_s)
            if history_window_ms is None:
                try:
                    unbounded = len(source) >= 2 ** 61
                except TypeError:      # no __len__: endless by contract
                    unbounded = True
                if unbounded:
                    history_window_ms = 36_000
            self.history_window_ms = history_window_ms
            self.records: List[EpochRecord] = []
            self.history: Dict[int, dict] = {}
            self._summarize = self._make_summarize()
            self._acq_chunk_fn = None
            self._acq_offs = None       # FDMA channel offsets (_acq_grid)
            self._acq_doppler = None    # on-chunk search's Doppler grid
            # Weak tier: a noncoherent search longer than one chunk sums
            # its power cube [num_prn, D, spc] on the device across chunks.
            self._acq_wk = None         # {"cube", "done", "base0"}
            self._acq_wk_fns = False    # lazy (accum, finish, B, B_c, need)
            espc = self._bpe * spc
            self._espc = espc
            self._win_len = espc + spc + self._drift_margin + 2
            self._chunk_len = self.chunk_samples(
                self.sig, epoch_ms, sync_every=self.sync_every,
                prefetch=self.prefetch, wire=self.wire,
                spread_budget_s=spread_budget_s)
            # Bytes of a host chunk, the size of a staging slot.
            self._stage_bytes = (
                int(self._chunk_len / up.samples_per_byte(self.wire))
                if self.wire is not None else self._chunk_len * 8)
            engine_step = self.eng.make_step(self._bpe)

            def step_epoch(win, bank, state):
                state, obs = engine_step(win, bank, state)
                state = _rows_map(state, lambda s, _: s._replace(
                    corr=s.corr._replace(
                        sample_pos=s.corr.sample_pos - espc)))
                return state, obs

            self._step_epoch = step_epoch

    @staticmethod
    def chunk_samples(sig: SignalConfig, epoch_ms: int, *,
                      sync_every: int = 1, prefetch: bool = False,
                      wire: Optional[str] = None,
                      spread_budget_s: float = 900.0) -> int:
        """Samples of one superepoch's chunk, the longest read the
        manager makes of its source, for these constructor arguments. A
        live stream source's history must hold more than this
        (runtime.sources.stream_blocks keeps two chunks)."""
        spc = sig.samples_per_code
        period_ms = int(round(sig.code_period_s * 1e3))
        sync_every = max(1, int(sync_every))
        espc = (epoch_ms // period_ms) * spc
        win_len = espc + spc + _drift_margin(sig, epoch_ms, sync_every,
                                             prefetch, spread_budget_s) + 2
        n = (sync_every - 1) * espc + win_len
        if wire is not None:
            n += (-n) % up.align(wire)
        return n

    # --- device placement (one device or a mesh) ---

    def _put_dev(self, x: np.ndarray, device=None) -> torch.Tensor:
        """Host bank array -> device tensor (uint32 rides int64). One of
        _PINNED_BYTES or more goes to a card through pinned host memory:
        a pageable copy that large holds the card for as long as the host
        takes to stage it."""
        dev = torch.device(device or self.device)
        if dev.type == "cuda" and x.nbytes >= _PINNED_BYTES \
                and x.dtype != np.uint32:
            return torch.from_numpy(np.ascontiguousarray(x)).pin_memory(
                ).to(dev, non_blocking=True)
        return to_device(x, dev)

    def _shard(self, state):
        """A whole [C]-leaved state, split over the mesh when there is
        one."""
        if self.mesh is None:
            return state
        return shard_rows(state, self.mesh)

    def _bank_to_device(self) -> dict:
        """The device bank: on a mesh, the engine's channel_keys split
        over the channel axis and every other buffer on the first
        device."""
        return {key: (shard_rows(v, self.mesh)
                      if self.mesh is not None
                      and key in self.eng.channel_keys
                      else self._put_dev(v))
                for key, v in self._bank.items()}

    def _set_bank_row(self, key: str, i: int) -> None:
        """Device copy of host bank row i, in the shard that holds it."""
        dst = self._bank_dev[key]
        if isinstance(dst, Sharded):
            j, r = divmod(i, self.cfg.n_channels // len(dst.parts))
            dst.parts[j][r] = self._put_dev(self._bank[key][i],
                                            dst.parts[j].device)
        else:
            dst[i] = self._put_dev(self._bank[key][i])

    def _epoch_windows(self, chunk: torch.Tensor, k: int) -> list:
        """The k epoch windows of a superepoch's device chunk; on a mesh,
        each replicated on every shard device."""
        espc, n = self._espc, self._win_len
        if self.mesh is None:
            return [chunk[j * espc: j * espc + n] for j in range(k)]
        rep = replicate(chunk, self.mesh)
        return [rep.map(lambda c, j=j: c[j * espc: j * espc + n])
                for j in range(k)]

    # --- slot control ---

    def _alloc(self, slot_idx: int, prn: int, code_phase: float,
               doppler_hz: float, epoch_ms: int) -> None:
        s = self.slots[slot_idx]
        s.state = (SlotState.CONFIRM if self.confirm_epochs > 0
                   else SlotState.TRACKING)
        s.prn = prn
        s.bad_epochs = 0
        s.confirm_good = 0
        s.confirm_seen = 0
        s.started_ms = epoch_ms
        # The engine fills the slot's code tables and consts in the host
        # bank; the device copy takes the changed rows in place.
        self.eng.write_slot(self._bank, slot_idx, prn)
        if self._bank_dev is not None:
            for key in self.eng.slot_keys:
                self._set_bank_row(key, slot_idx)
        # Reset the slot's state row on the device (in its shard). Out of
        # place: the state leaves may share storage (TrackState.init) or
        # be views of one kernel output, so each leaf is copied before the
        # row write.
        one = self.eng.slot_state(doppler_hz, self.device)

        def set_row(s, rows):
            lo = rows.start or 0
            if not lo <= slot_idx < (rows.stop or len(self.slots)):
                return s

            def put(full, row):
                full = full.clone()
                full[slot_idx - lo] = row[0].to(full.device, full.dtype)
                return full

            return tree_map(put, s, one)

        self._state = _rows_map(self._state, set_row)
        self._abs_pos[slot_idx] = code_phase
        if self._alloc_log is not None:
            self._alloc_log.append(slot_idx)
        # A reacquired PRN's stream restarts (start_ms changes, so the
        # navigator drops its anchors for this PRN).
        self.history[prn] = self._new_history(slot_idx, epoch_ms,
                                              doppler_hz)
        self.tlm.event(epoch_ms, "channel_start", chan=slot_idx, prn=prn,
                       code_phase=round(float(code_phase), 1),
                       doppler_hz=round(float(doppler_hz), 1))

    def _new_history(self, slot_idx: int, start_ms: int,
                     doppler_hz: float, evicted: int = 0) -> dict:
        """Fresh per-PRN history dict, with the host mirror of the
        correlator's uint32 carrier NCO (tracking.carrier)."""
        from gnsstpu_torch.tracking.carrier import CarrierPhaseAccumulator

        hist = {"i_p": [], "q_p": [], "carr_doppler": [],
                "abs_sample": [], "carr_cycles": [],
                "start_ms": start_ms, "evicted": evicted,
                "_cph": CarrierPhaseAccumulator(
                    int(self._bank["carr_base"][slot_idx]), self.sig.fs,
                    doppler_hz)}
        if self.eng.has_data_component:
            hist["i_p2"] = []
            hist["q_p2"] = []
        return hist

    def _drop(self, slot_idx: int, epoch_ms: int, why: str) -> None:
        s = self.slots[slot_idx]
        self.tlm.event(epoch_ms, "channel_drop", chan=slot_idx, prn=s.prn,
                       why=why)
        s.state = SlotState.IDLE
        s.prn = 0
        s.bad_epochs = 0

    def _tracked_prns(self) -> set:
        return {s.prn for s in self.slots if s.state is not SlotState.IDLE}

    def _want_prns(self) -> list:
        want = [p for p in self.pool if p not in self._tracked_prns()]
        if self.warm_visible is not None:
            want = [p for p in want
                    if p not in self.warm_known or p in self.warm_visible]
        return want

    # --- sample reads (wire-format aware) ---

    def _read_superepoch(self, base: int, k: int):
        """One superepoch's chunk: sized read + end-of-data detection +
        zero-pad to the static chunk length (the tail superepoch reads
        only what its k epoch windows consume). Thread-safe."""
        chunk_len = self._chunk_len
        need_len = (k - 1) * self._espc + self._win_len
        if self.wire is not None:
            need_len += (-need_len) % up.align(self.wire)
        need_len = min(need_len, chunk_len)
        with self._src_lock:
            buf = self._read_chunk(base, need_len)
            if self.wire is not None:
                # Packed zero bytes decode to nonzero levels, so the end
                # of a packed source is positional (or producer EOS).
                ended = base >= len(self.source) or (
                    hasattr(self.source, "ended_at")
                    and self.source.ended_at(base))
            else:
                try:
                    src_len = len(self.source)
                except TypeError:
                    src_len = None
                if src_len is not None and src_len < 2 ** 61:
                    ended = base >= src_len
                else:
                    ended = not np.any(buf[: self._espc])
        if need_len < chunk_len:
            if self.wire is not None:
                spb = up.samples_per_byte(self.wire)
                pad_shape: tuple = (int((chunk_len - need_len) / spb),)
                pad_np, pad_t = np.uint8, torch.uint8
            else:
                pad_shape = (chunk_len - need_len, 2)
                pad_np, pad_t = np.float32, torch.float32
            if isinstance(buf, torch.Tensor):
                buf = torch.cat([buf, torch.zeros(pad_shape, dtype=pad_t,
                                                  device=buf.device)])
            else:
                buf = np.concatenate([np.asarray(buf),
                                      np.zeros(pad_shape, pad_np)])
        self._consec_restarts = 0
        return buf, ended, need_len

    def _read_chunk(self, start: int, count: int):
        if self.wire is not None:
            return self.source.read_packed(start, count)
        return self.source.read(start, count)

    def _upload(self, buf):
        """Upload + decode to f32 [N, 2] on the device, inside the
        caller's feed.upload span (`decoded`: the samples the wire table
        decoded; `staged`: the bytes that crossed through the pinned
        ring; `stage_waits`: the host's waits for a ring slot). Returns
        (the tensor, ready): a host chunk bound for a card crosses
        through the process's staging ring (feed_stage) on the ring's
        stream, and its readers' stream waits on ready
        (feed_stage.consume) before reading it. ready is None where the
        tensor is ready on the current stream: on the CPU, and for a
        device-resident source, whose chunk only the unpack reads."""
        on_host = not isinstance(buf, torch.Tensor) \
            or buf.device.type == "cpu"
        if on_host and self.device.type == "cuda":
            dtype = np.uint8 if self.wire is not None else np.float32
            host = torch.from_numpy(np.ascontiguousarray(buf, dtype))
            ring = feed_stage.ring(self.device, self._stage_bytes)
            dev, ready, waited = ring.upload(
                host, None if self.wire is None
                else lambda d: up.unpack(d, self.wire))
            self.tlm.count(staged=host.nbytes, stage_waits=waited)
            if self.wire is not None:
                self.tlm.count(decoded=dev.shape[0])
            return dev, ready
        if self.wire is not None:
            if not isinstance(buf, torch.Tensor):
                buf = torch.from_numpy(np.ascontiguousarray(buf, np.uint8))
            dev = up.unpack(buf.to(self.device), self.wire)
            self.tlm.count(decoded=dev.shape[0])
            return dev, None
        if isinstance(buf, torch.Tensor):
            return buf.to(self.device, torch.float32), None
        return torch.as_tensor(np.asarray(buf, np.float32),
                               device=self.device), None

    def _to_device(self, buf) -> torch.Tensor:
        """_upload's tensor, ready for the current stream."""
        return feed_stage.consume(*self._upload(buf))

    # --- acquisition scheduling ---

    def _try_acquire(self, epoch_ms: int) -> None:
        """Host-path acquisition over its own sample window (used when
        nothing is tracking yet)."""
        idle = [i for i, s in enumerate(self.slots)
                if s.state is SlotState.IDLE]
        want = self._want_prns()
        if not idle or not want:
            return
        acq_cfg = dataclasses.replace(self.cfg.acq, prn_list=tuple(want))
        need = acq_samples_needed(self.sig, acq_cfg)
        if self.wire is not None:
            if self._cursor + need > len(self.source) or (
                    hasattr(self.source, "ended_at")
                    and self.source.ended_at(self._cursor + need)):
                return
        try:
            with self._src_lock:
                samples = self.source.read(self._cursor, need)
        except TimeoutError:
            if self._recover_stall(epoch_ms):
                return
            raise
        if not np.any(samples):
            return
        fdma = self.sd.fdma_zero_prn is not None
        search = acquire_fdma if fdma else acquire
        res = search(samples, self.sig, acq_cfg, device=self.device)
        self.tlm.count(codes=res.codes, combined=int(res.combined))
        self._place(res, idle, want, self._cursor, epoch_ms, fdma=fdma)

    def _place(self, res, idle: list, want: list, base: int,
               epoch_ms: int, fdma: bool) -> None:
        """Allocate detected PRNs into idle slots (handoff to tracking)."""
        order = np.argsort(-res.peak_metric)
        for i in order:
            prn = int(i) + 1
            if (not res.detected[i] or prn not in want
                    or prn in self._tracked_prns()):
                continue
            if not idle:
                break
            slot = idle.pop(0)
            dopp = float(res.carr_freq[i]) - self.sig.if_freq
            if fdma:   # Doppler relative to this PRN's own channel carrier
                dopp -= (self.sd.carrier_freq(prn)
                         - self.sd.carrier_freq(self.sd.fdma_zero_prn))
            self._alloc(slot, prn,
                        code_phase=base + float(res.code_phase[i]),
                        doppler_hz=dopp, epoch_ms=epoch_ms)

    def _acq_grid(self):
        """Search-grid geometry of the on-chunk search and the weak-tier
        accumulator, built in this one place so that _finish_chunk_acq
        reads code_phase / doppler_bin the same way for both.

        CDMA: the all-PRN code bank against the Doppler grid around IF.
        FDMA (GLONASS L1/L2): one shared code row against the flattened
        [channel x Doppler] carrier grid (acquire_fdma's). Sets
        self._acq_offs (FDMA channel offsets, else None) and
        self._acq_doppler (the Doppler grid, around 0 for FDMA); returns
        (code_fd, grid_dev, fdma, K, D, spchip)."""
        acq = self.cfg.acq
        sig = self.sig
        code_fd = code_fd_tensor(sig, acq, self.device)
        fdma = self.sd.fdma_zero_prn is not None
        if fdma:
            code_fd = code_fd[:1]                 # one shared code
            self._acq_offs, dopp, grid = fdma_grid(sig, acq)
        else:
            dopp = fft_acquire.doppler_grid(
                sig.if_freq, acq.doppler_band, acq.doppler_bin_step())
            grid = dopp
            self._acq_offs = None
        self._acq_doppler = dopp
        return (code_fd, torch.as_tensor(grid, dtype=torch.float32,
                                         device=self.device),
                fdma, self.sd.num_prn, len(dopp),
                round(sig.fs / sig.code_freq))

    def _make_acq_chunk_fn(self):
        """Cold search over the leading window of an uploaded device
        chunk: reacquisition rides the superepoch's transfer (grid:
        _acq_grid). Returns search(chunk, want) -> f32 [3, P] (metric,
        code_phase, doppler_bin). A CDMA search correlates only the code
        rows of the PRNs in `want` (bank_rows: their pilot rows and the
        data rows summed into them), the same numbers for those PRNs as a
        search of the whole bank; the lanes of the other PRNs read 0
        unless that is the whole bank. FDMA searches its one shared code
        over every channel whatever `want`."""
        acq = self.cfg.acq
        sig = self.sig
        spc = sig.samples_per_code
        B, combine = _windows_of(acq)
        L = acq.coherent_ms * spc
        Lw = fft_acquire.window_len(spc, acq.coherent_ms)
        code_fd, grid, fdma, K, D, spchip = self._acq_grid()
        memo = {}   # the last want's (n_rows, first_data, sub-bank, pilots)

        def bank(want):
            if fdma:
                return code_fd.shape[0], None, code_fd, None
            key = tuple(sorted(set(want)))
            if key not in memo:
                rows, first = bank_rows(sig.signal, K, key)
                if len(rows) == K:
                    sub, pilots = code_fd, None
                else:
                    sub = code_fd.index_select(0, torch.as_tensor(
                        rows, device=code_fd.device))
                    pilots = torch.as_tensor([p - 1 for p in key],
                                             device=code_fd.device)
                memo.clear()
                memo[key] = (len(rows), first, sub, pilots)
            return memo[key]

        def search(chunk, want):
            blocks = torch.stack([chunk[k * L: k * L + Lw]
                                  for k in range(B)])
            n_rows, first, sub, pilots = bank(want)
            cube = fft_acquire.acquire_cube(blocks, sub, grid, sig.fs,
                                            spc, combine=combine)
            if fdma:
                cube = cube.reshape(K, D, spc)
            both = combine_components(cube, sig.signal, first)
            self.tlm.count(codes=n_rows, combined=int(both))
            if pilots is None:
                return self._peak_lanes(cube, spc, spchip)
            lanes = self._peak_lanes(cube[:len(pilots)], spc, spchip)
            return lanes.new_zeros((3, K)).index_copy_(1, pilots, lanes)

        return search

    @staticmethod
    def _peak_lanes(cube, spc: int, spchip: int) -> torch.Tensor:
        """f32 [3, P] (metric, code_phase, doppler_bin) of a power cube,
        one tensor for one readback."""
        m = fft_acquire.peak_metrics(cube, samples_per_code=spc,
                                     samples_per_chip=spchip)
        return torch.stack([m["metric"],
                            m["code_phase"].to(torch.float32),
                            m["doppler_bin"].to(torch.float32)])

    def _acq_samples_needed_chunk(self) -> int:
        B, _ = _windows_of(self.cfg.acq)
        spc = self.sig.samples_per_code
        return ((B - 1) * self.cfg.acq.coherent_ms * spc
                + fft_acquire.window_len(spc, self.cfg.acq.coherent_ms))

    # --- cross-superepoch weak-tier acquisition ---

    def _make_acq_wk(self):
        """Lazy-build the weak-tier accumulation: accum(chunk, cube, roll)
        adds one chunk's B_c noncoherent windows into the persistent
        device cube, the code-phase axis rolled into the accumulation's
        base frame; finish(cube) gives the [3, P] peak lanes. Returns
        None when the config cannot accumulate (not a sum tier, or the
        chunk cannot hold one window without overlapping the next)."""
        if self._acq_wk_fns is not False:
            return self._acq_wk_fns
        acq = self.cfg.acq
        sig = self.sig
        spc = sig.samples_per_code
        B, combine = _windows_of(acq)
        L = acq.coherent_ms * spc
        Lw = fft_acquire.window_len(spc, acq.coherent_ms)
        # Windows per chunk are sized to the chunk ADVANCE (k * espc), not
        # its length: consecutive chunks overlap by win_len - espc samples
        # and a window reaching into the overlap would be summed twice.
        # An advance shorter than one window fits none without overlap:
        # unsupported, the host-path search takes over.
        adv = self._espc * self.sync_every
        if combine != "sum" or Lw > self._chunk_len or adv < Lw:
            self._acq_wk_fns = None
            return None
        B_c = min(B, (adv - Lw) // L + 1)
        need = (B_c - 1) * L + Lw      # samples one accumulate reads
        code_fd, grid, fdma, K, D, spchip = self._acq_grid()

        def accum(chunk, cube, roll: int):
            blocks = torch.stack([chunk[k * L: k * L + Lw]
                                  for k in range(B_c)])
            part = fft_acquire.acquire_cube(blocks, code_fd, grid, sig.fs,
                                            spc, combine="sum")
            self.tlm.count(codes=code_fd.shape[0])
            if fdma:
                part = part.reshape(K, D, spc)
            # Later chunks start at another stream base: rotate the
            # code-phase axis into the first chunk's frame (a peak for
            # code start s sits at (s - base) mod spc).
            return cube + torch.roll(part, roll, dims=-1)

        def finish(cube):
            both = combine_components(cube, sig.signal)
            self.tlm.count(combined=int(both))
            return self._peak_lanes(cube, spc, spchip)

        self._acq_wk_fns = (accum, finish, B, B_c, need)
        return self._acq_wk_fns

    def _wk_step(self, chunk_dev, base: int, need_len: int):
        """Advance the cross-superepoch weak search by one chunk. Returns
        ('unsupported', None, 0) | ('pending', None, 0) | ('done', [3, P]
        device metrics, base0)."""
        fns = self._make_acq_wk()
        if fns is None:
            return ("unsupported", None, 0)
        accum, finish, B, B_c, need = fns
        if need_len < need:
            # Tail / short chunk: pause, keep the accumulated cube.
            return ("pending", None, 0)
        spc = self.sig.samples_per_code
        if self._acq_wk is None:
            # Cube rows: every PRN (CDMA code bank) or every frequency
            # channel (FDMA), both sd.num_prn.
            self._acq_wk = {
                "cube": torch.zeros(
                    (self.sd.num_prn, len(self._acq_doppler), spc),
                    dtype=torch.float32, device=self.device),
                "done": 0, "base0": int(base)}
        wk = self._acq_wk
        roll = (int(base) - wk["base0"]) % spc
        wk["cube"] = accum(chunk_dev, wk["cube"], roll)
        wk["done"] += B_c
        if wk["done"] >= B:
            lanes = finish(wk["cube"])
            base0 = wk["base0"]
            self._acq_wk = None
            return ("done", lanes, base0)
        return ("pending", None, 0)

    def _chunk_search(self, chunk_dev, base: int, need_len: int,
                      want: list):
        """A due search for the PRNs in `want` against an uploaded chunk:
        the full search when it fits the chunk (an accumulation in
        progress is then stale), else one weak-tier step (the whole
        bank). Returns (device [3, P] metrics or None, their base,
        host-path fallback wanted)."""
        if need_len >= self._acq_samples_needed_chunk():
            self._acq_wk = None
            if self._acq_chunk_fn is None:
                self._acq_chunk_fn = self._make_acq_chunk_fn()
            return self._acq_chunk_fn(chunk_dev, want), base, False
        st, lanes, base0 = self._wk_step(chunk_dev, base, need_len)
        if st == "done":
            return lanes, base0, False
        return None, base, st == "unsupported"

    def _host_samples(self, start: int, count: int) -> np.ndarray:
        """f32 [count, 2] host samples, from the retained chunk buffer
        when it covers the request, else from the source."""
        cc = self._chunk_cache
        if cc is not None:
            cbase, cbuf = cc
            off = start - cbase
            if off >= 0 and not isinstance(cbuf, torch.Tensor):
                if self.wire is not None:
                    a = up.align(self.wire)
                    spb = up.samples_per_byte(self.wire)
                    o0 = off - off % a
                    n = count + (off - o0)
                    n += (-n) % a
                    if o0 + n <= int(len(cbuf) * spb):
                        dec = up.unpack_np(
                            np.asarray(cbuf)[int(o0 / spb):
                                             int((o0 + n) / spb)],
                            self.wire)
                        return dec[off - o0: off - o0 + count]
                elif off + count <= len(cbuf):
                    return np.asarray(cbuf[off: off + count], np.float32)
        with self._src_lock:
            return self.source.read(start, count)

    def _finish_chunk_acq(self, metrics, want: list, base: int,
                          epoch_ms: int,
                          head: Optional[int] = None) -> None:
        """Apply an on-chunk search's host peak metrics [3, P]: threshold,
        fine Doppler (host window), Doppler-corrected handoff to `head`,
        slot placement."""
        if head is None:
            head = self._cursor
        acq = self.cfg.acq
        metrics = np.asarray(metrics)
        metric = metrics[0]
        code_phase = metrics[1].astype(np.int64)
        best_bin = metrics[2].astype(np.int64)
        allowed = np.zeros(self.sd.num_prn, bool)
        allowed[[p - 1 for p in want]] = True
        detected = (metric > acq.threshold) & allowed
        fdma = self._acq_offs is not None
        carr = self._acq_doppler[best_bin].astype(np.float64)
        if fdma:   # absolute carrier: IF + channel offset + Doppler bin
            carr = carr + self.sig.if_freq + self._acq_offs
        k_ms = fine_doppler_ms(self.sig, acq)
        if k_ms > 0 and np.any(detected):
            win = self._host_samples(base, (k_ms + 1) * self.sig.
                                     samples_per_code + 64)
            # Refine only against a fully covered window: a weak search's
            # base can predate the retained chunk, and a zero-filled part
            # corrupts the estimate.
            covered = np.count_nonzero(
                np.abs(win).sum(axis=1)) >= 0.99 * len(win)
            if covered:
                for i in np.nonzero(detected)[0]:
                    carr[i] = refine_doppler(
                        win, self.sig, int(i) + 1, int(code_phase[i]),
                        carr[i], k_ms=k_ms)
        # The search measured code phase in this chunk; the slot starts at
        # `head`: advance by whole, Doppler-corrected code periods.
        spc = self.sig.samples_per_code
        abs_cp = base + code_phase.astype(np.float64)
        fc = np.array([self.sd.carrier_freq(p)
                       for p in range(1, self.sd.num_prn + 1)], np.float64)
        fd = carr - self.sig.if_freq
        if fdma:   # Doppler relative to each channel's own carrier
            fd = fd - self._acq_offs
        step = spc * (1.0 - fd / fc)
        adv = np.maximum(np.ceil((head - abs_cp) / step), 0.0)
        abs_cp = abs_cp + adv * step
        res = AcqResults(peak_metric=metric, code_phase=abs_cp,
                         carr_freq=carr, detected=detected)
        idle = [i for i, s in enumerate(self.slots)
                if s.state is SlotState.IDLE]
        self._place(res, idle, want, base=0, epoch_ms=epoch_ms, fdma=fdma)

    # --- device-side epoch summary ---

    # Stream lanes [E, C, 5(+2 data prompts)] and stats lanes [C, 4].
    (_S_IP, _S_QP, _S_REM, _S_BLK, _S_DOPP, _S_IP2, _S_QP2) = range(7)
    (_T_CN0, _T_PLL, _T_CODE, _T_LOCKED) = range(4)

    def _make_summarize(self):
        """summarize(obs, cn0_drop, out, j) fills epoch slot j of a
        superepoch's readback `out` (_new_readback) with the epoch's
        device summary: lock stats [C, 4] from assess_device's formulas
        plus the per-block streams, as f32 lanes or (compact) f16 prompts
        / u16 rem / i16 blksize delta / f32 Doppler; a dual-component
        engine adds its data prompts (two more lanes or prompts). One
        launch of ops.summary_kernel's kernel on the card (returns True),
        its plain version on the CPU (False)."""
        m = min(20, max(1, self._bpe))
        spc_nom = int(self.sig.samples_per_code)
        t_int = self.sig.code_period_s

        def summarize(obs, cn0_drop, out, j):
            return summary_kernel.epoch_summary(
                obs, out, j, m=m, t_int_s=t_int, cn0_drop_dbhz=cn0_drop,
                spc=spc_nom)

        return summarize

    def _new_readback(self, k: int) -> list:
        """The tensors of one k-epoch readback, which summarize fills
        slot by slot: (streams [k,E,C,5(+2)], stats [k,C,4]), or one byte
        buffer (compact)."""
        return summary_kernel.new_readback(
            k, self._bpe, self.cfg.n_channels,
            dual=self.eng.has_data_component,
            compact=self.readback == "compact", device=self.device)

    def _decode_readback(self, raw: list):
        """Canonical (streams [K,E,C,5(+2)] f32, stats [K,C,4]) from the
        host copy of a packed readback."""
        if self.readback != "compact":
            return raw[0], raw[1]
        dual = self.eng.has_data_component
        E, C = self._bpe, self.cfg.n_channels
        buf = torch.from_numpy(raw[0])
        K = buf.numel() // sum(summary_kernel.compact_sizes(1, E, C, dual))
        pp, rem, blkd, dopp, st = (v.numpy() for v in
                                   summary_kernel.compact_views(
                                       buf, K, E, C, dual))
        rem = rem.view(np.uint16).astype(np.float32) / np.float32(65535.0)
        spc = np.float32(self.sig.samples_per_code)
        streams = np.empty((K, E, C, 7 if dual else 5), np.float32)
        streams[..., self._S_IP] = pp[..., 0].astype(np.float32) * spc
        streams[..., self._S_QP] = pp[..., 1].astype(np.float32) * spc
        streams[..., self._S_REM] = rem
        streams[..., self._S_BLK] = (blkd.astype(np.float32)
                                     + self.sig.samples_per_code)
        streams[..., self._S_DOPP] = dopp
        if dual:
            streams[..., self._S_IP2] = pp[..., 2].astype(np.float32) * spc
            streams[..., self._S_QP2] = pp[..., 3].astype(np.float32) * spc
        return streams, st

    # --- main loop: one superepoch body, two drivers ---
    #
    # Each step of a superepoch is written once (_cold_search, _rebase,
    # _dispatch_superepoch with _due_search, _materialize, _stage_health,
    # _finish_search); _run_superepoch and _run_pipelined drive them.

    def run(self, n_ms: int) -> List[EpochRecord]:
        """Process n_ms of signal. Epoch labels form one monotonic
        receiver clock across successive run() calls."""
        e0 = self._clock_epochs
        n_epochs = e0 + n_ms // self.epoch_ms
        self._last_progress = time.monotonic()
        if self.prefetch and self.sync_every > 1:
            self._run_pipelined(e0, n_epochs)
            return self.records
        e = e0
        while e < n_epochs:
            k = min(self.sync_every, n_epochs - e)
            if not self._run_superepoch(e, k):
                break
            e += k
            self._clock_epochs = e
        return self.records

    @property
    def clock_ms(self) -> int:
        """Receiver-clock milliseconds processed so far."""
        return self._clock_epochs * self.epoch_ms

    def _active(self) -> list:
        return [i for i, s in enumerate(self.slots)
                if s.state is not SlotState.IDLE]

    def _commanded_stop(self, epoch_ms: int) -> bool:
        """Apply the runtime commands at a superepoch boundary; True (and
        a commanded_stop record) once a stop was commanded."""
        if self.commands is not None:
            self._apply_commands(epoch_ms)
        if self._stop:
            self.tlm.event(epoch_ms, "commanded_stop")
        return self._stop

    def _host_search(self, se: int, epoch_ms: int) -> None:
        """The host-path search for slots starting at epoch_ms, in its
        acq.host_search span (key se), and its acquire record."""
        with self.tlm.span("acq.host_search", se=se) as acq:
            self._try_acquire(epoch_ms)
        self.tlm.task_health(epoch_ms, "acquire", acq.wall_s)

    def _cold_search(self, epoch_ms: int) -> list:
        """A due search with nothing tracking: the host path, over its own
        window. Returns the active slots."""
        self._host_search(epoch_ms, epoch_ms)
        self._next_reacq_ms = epoch_ms + self.reacq_period_ms
        return self._active()

    def _base(self, active: list) -> int:
        """Chunk base of a host rebase: the earliest active slot,
        aligned to the wire format."""
        base = int(min(self._abs_pos[i] for i in active))
        if self.wire is not None:
            base -= base % up.align(self.wire)
        return base

    def _rebase(self, base: int, active: list, epoch_ms: int) -> np.ndarray:
        """Every slot's sample_pos relative to base; idle slots start at
        base. A channel drifted past the window budget would read beyond
        its epoch window: it is dropped (re-anchored via reacquisition)
        and leaves `active`."""
        for i, s in enumerate(self.slots):
            if s.state is SlotState.IDLE:
                self._abs_pos[i] = base
        rel = np.round(self._abs_pos - base).astype(np.int64)
        for i in list(active):
            if rel[i] > self._drift_margin:
                self._drop(i, epoch_ms, why="window_overrun")
                self._abs_pos[i] = base
                rel[i] = 0
                active.remove(i)
        return rel

    def _dispatch_superepoch(self, chunk: _Chunk, k: int, e0: int,
                             acq_due: bool, delta: int, mask: np.ndarray,
                             newsp: np.ndarray) -> _Inflight:
        """Issue one superepoch against an uploaded chunk (the current
        stream first waits for a staged upload on the card): retarget
        sample_pos (every row shifted by delta, the rows in mask set to
        newsp), k epochs of (kernel launch + device summary), the
        readback copy and a due search. Device work and copies are
        async."""
        epoch_ms0 = e0 * self.epoch_ms
        tlm = self.tlm

        def retarget(s, rows):
            dev = s.corr.sample_pos.device
            sp = s.corr.sample_pos + int(delta)
            sp = torch.where(torch.as_tensor(mask[rows], device=dev),
                             torch.as_tensor(newsp[rows].astype(np.int32),
                                             device=dev), sp)
            return s._replace(corr=s.corr._replace(sample_pos=sp))

        sup = tlm.open_span("superepoch", se=epoch_ms0)
        kernel_events = [] if tlm.trace else None
        with tlm.span("dispatch", se=epoch_ms0, k=k) as disp:
            feed_stage.consume(chunk.dev, chunk.ready)
            if self._bank_dev is None:
                self._bank_dev = self._bank_to_device()
            state = _rows_map(self._state, retarget)
            packed = self._new_readback(k)
            n_sum = 0
            with track_kernel.timed_launches(kernel_events):
                for j, win in enumerate(self._epoch_windows(chunk.dev, k)):
                    state, obs = self._step_epoch(win, self._bank_dev,
                                                  state)
                    n_sum += self._summarize(obs, float(self.cn0_drop),
                                             packed, j)
            tlm.count(summaries=n_sum)
            self._state = state
            packed = _Readback(packed)
            acq_fut, acq_base, acq_host, want = self._due_search(
                chunk, acq_due, epoch_ms0)
            n_active = len(self._active())
            tlm.count(n_active=n_active)
        return _Inflight(e0=e0, k=k, base=chunk.base, packed=packed,
                         acq_fut=acq_fut, acq_want=want,
                         acq_host=acq_host, buf=chunk.buf,
                         n_active=n_active, read=chunk.read,
                         upload=chunk.upload, dispatch=disp, span=sup,
                         kernel_events=kernel_events, acq_base=acq_base)

    def _due_search(self, chunk: _Chunk, acq_due: bool, epoch_ms0: int):
        """A due search (or the weak tier's next step) on the chunk, for
        the PRNs the idle slots may take; with nothing to search for, an
        accumulation in progress is dropped. Returns (readback of its
        [3, P] lanes or None, their base, host-path fallback wanted, the
        PRNs searched for)."""
        acq_fut, acq_base, acq_host, want = None, chunk.base, False, []
        if acq_due or self._acq_wk is not None:
            want = self._want_prns()
            if want and any(s.state is SlotState.IDLE for s in self.slots):
                with self.tlm.span("acq.chunk_search"):
                    lanes, acq_base, host = self._chunk_search(
                        chunk.dev, chunk.base, chunk.need_len, want)
                if lanes is not None:
                    acq_fut = _Readback([lanes])
                acq_host = host and acq_due
            else:
                self._acq_wk = None
            if acq_due:
                self._next_reacq_ms = epoch_ms0 + self.reacq_period_ms
        return acq_fut, acq_base, acq_host, want

    def _materialize(self, packed: _Readback, acq_fut, se: int,
                     kernel_events: Optional[list]):
        """Wait for a superepoch's readback copy (and the search
        metrics) and decode it: the fetch thread's body when pipelined.
        Returns (canonical streams, search metrics or None, the
        superepoch span's kernel counters). K1's and K3's timing events
        are read once the readback's event, queued behind them, has
        completed."""
        tlm = self.tlm
        with tlm.span("fetch.device_wait", se=se):
            packed.wait()
            if acq_fut is not None:
                acq_fut.wait()
        timing = track_kernel.event_counters(kernel_events or [])
        with tlm.span("fetch.decode", se=se):
            streams = self._decode_readback(packed.numpy())
            acq = acq_fut.numpy()[0] if acq_fut is not None else None
        return streams, acq, timing

    def _stage_health(self, p: _Inflight, readback_s: float) -> None:
        """A superepoch's track, upload, readback and source records, the
        walls from the spans that timed them."""
        tlm = self.tlm
        epoch_ms0 = p.e0 * self.epoch_ms
        tlm.task_health(epoch_ms0, "track", p.dispatch.wall_s,
                        engine=self.engine, n_active=p.n_active,
                        sync_every=p.k)
        tlm.task_health(epoch_ms0, "upload", p.upload.wall_s,
                        wire=self.wire or "array",
                        read_s=round(p.read.wall_s, 4))
        tlm.task_health(epoch_ms0, "readback", readback_s)
        if hasattr(self.source, "stats"):
            tlm.task_health(epoch_ms0, "source", 0.0,
                            **self.source.stats())

    def _finish_search(self, p: _Inflight, acq, alloc_ms: int,
                       head: Optional[int] = None) -> None:
        """Place a superepoch's search results in slots starting at
        alloc_ms (handoff to `head`, _finish_chunk_acq), or run the
        host-path search it fell back to."""
        epoch_ms0 = p.e0 * self.epoch_ms
        if acq is not None:
            with self.tlm.span("acq.finish", se=epoch_ms0):
                self._finish_chunk_acq(acq, p.acq_want, p.acq_base,
                                       alloc_ms, head=head)
        elif p.acq_host:
            self._host_search(epoch_ms0, alloc_ms)

    def _run_superepoch(self, e0: int, k: int) -> bool:
        """The serial driver: k supervision epochs in one device round
        trip, every row rebased from the host. Returns False to stop (end
        of data / commanded stop)."""
        tlm = self.tlm
        epoch_ms0 = e0 * self.epoch_ms
        if self._commanded_stop(epoch_ms0):
            return False
        active = self._active()
        acq_due = epoch_ms0 >= self._next_reacq_ms
        if acq_due and not active:
            active = self._cold_search(epoch_ms0)
            acq_due = False
        if not active:
            self._cursor += k * self._espc
            self._watchdog()
            return True
        base = self._base(active)
        try:
            with tlm.span("feed.read", se=epoch_ms0) as read:
                buf, ended, need_len = self._read_superepoch(base, k)
        except TimeoutError:
            if self._recover_stall(epoch_ms0):
                return True
            raise
        if ended:
            tlm.event(epoch_ms0, "end_of_data")
            return False
        self._chunk_cache = (base, buf)
        rel = self._rebase(base, active, epoch_ms0)
        if not active:
            self._cursor = base + k * self._espc
            return True
        with tlm.span("feed.upload", se=epoch_ms0, bytes=_host_bytes(buf),
                      decoded=0, staged=0, stage_waits=0) as upload:
            dev, ready = self._upload(buf)
        chunk = _Chunk(base=base, k=k, buf=buf, dev=dev, ended=False,
                       need_len=need_len, read=read, upload=upload,
                       ready=ready)
        p = self._dispatch_superepoch(chunk, k, e0, acq_due, delta=0,
                                      mask=np.ones(len(self.slots), bool),
                                      newsp=rel)
        with tlm.span("readback", se=epoch_ms0) as rb:
            (streams, stats), acq, timing = self._materialize(
                p.packed, p.acq_fut, epoch_ms0, p.kernel_events)
        self._stage_health(p, rb.wall_s)
        with tlm.span("supervise", se=epoch_ms0) as sv:
            self._abs_pos = self._supervise_block(
                streams, stats, base + rel.astype(np.float64), e0)
            self._cursor = base + k * self._espc
            self._last_progress = time.monotonic()
        tlm.task_health(epoch_ms0, "assess", sv.wall_s)
        self._finish_search(p, acq, (e0 + k) * self.epoch_ms)
        tlm.close_span(p.span, **timing)
        return True

    # --- the prefetch pipeline's driver ---

    def _prefetch_chunk(self, base: int, k: int, se: int) -> _Chunk:
        """Read + upload one superepoch chunk (on the reader thread, or
        on the supervision thread when the prefetch missed); se: the key
        of the superepoch it is read for."""
        tlm = self.tlm
        with tlm.span("feed.read", se=se) as read:
            buf, ended, need_len = self._read_superepoch(base, k)
        with tlm.span("feed.upload", se=se,
                      bytes=0 if ended else _host_bytes(buf),
                      decoded=0, staged=0, stage_waits=0) as upload:
            dev, ready = (None, None) if ended else self._upload(buf)
        return _Chunk(base=base, k=k, buf=buf, dev=dev, ended=ended,
                      need_len=need_len, read=read, upload=upload,
                      ready=ready)

    def _next_base(self, active: list, la: int, k: int, det: int) -> int:
        """Base for the next chunk: follow the fleet's positions (min
        active, la superepochs ahead, minus a guard for backward drift)
        so a long run never walks rel negative or past the budget."""
        guard = 128
        minp = min(self._abs_pos[i] for i in active)
        desired = int(minp) + la * k * self._espc - guard
        if self.wire is not None:
            desired -= desired % up.align(self.wire)
        if abs(desired - det) > self._drift_margin:
            return det
        return desired

    def _run_pipelined(self, e0: int, n_epochs: int) -> None:
        """The prefetch pipeline's driver. The device state carries across
        superepochs (each epoch rebases sample_pos by -espc), so
        dispatching superepoch n+1 needs no host round trip: per
        iteration it starts the reader thread's prefetch of chunk n+1,
        dispatches superepoch n on the prefetched chunk, then harvests
        and supervises superepoch n-1. Only entry rebases from the host;
        slots placed by a harvest start one superepoch later."""
        espc = self._espc
        tlm = self.tlm
        ex = ThreadPoolExecutor(max_workers=1,     # reader / uploader
                                thread_name_prefix="gnss-feed")
        fx = ThreadPoolExecutor(max_workers=1,     # readback fetcher
                                thread_name_prefix="gnss-fetch")
        pend: Optional[_Inflight] = None
        nxt = None                 # Future[_Chunk] targeting self._cursor
        entry = True               # host sample_pos rebase needed
        self._pending_allocs: List[int] = []
        self._det_base = 0
        e = e0
        try:
            while e < n_epochs:
                k = min(self.sync_every, n_epochs - e)
                epoch_ms0 = e * self.epoch_ms
                if self._commanded_stop(epoch_ms0):
                    break
                active = self._active()
                if not active:
                    if pend is not None:
                        # Drain the in-flight superepoch first: its
                        # search may repopulate the bank.
                        self._harvest(pend, next_base=self._cursor,
                                      alloc_ms=epoch_ms0)
                        self._clock_epochs = e
                        pend = None
                        entry = True
                        continue
                    nxt = None
                    if epoch_ms0 >= self._next_reacq_ms:
                        active = self._cold_search(epoch_ms0)
                    if not active:
                        self._cursor += k * espc
                        self._watchdog()
                        e += k
                        self._clock_epochs = e
                        continue
                    entry = True
                entry_rel = None
                if entry:
                    base = self._base(active)
                    rel = self._rebase(base, active, epoch_ms0)
                    if not active:
                        self._cursor = base + k * espc
                        continue
                    entry_rel = rel
                    self._pending_allocs = []
                    self._cursor = base
                    nxt = None
                    entry = False
                base = self._cursor
                try:
                    with tlm.span("feed.wait", se=epoch_ms0):
                        if nxt is not None:
                            chunk = nxt.result()
                            nxt = None
                            if chunk.base != base or chunk.k < k:
                                chunk = self._prefetch_chunk(base, k,
                                                             epoch_ms0)
                        else:
                            chunk = self._prefetch_chunk(base, k, epoch_ms0)
                except TimeoutError:
                    nxt = None
                    if self._recover_stall(epoch_ms0):
                        entry = True
                        continue
                    raise
                if chunk.ended:
                    self.tlm.event(epoch_ms0, "end_of_data")
                    break
                # sample_pos retarget: entry rebases every row from the
                # host bookkeeping; steady state shifts the carried rows
                # by the base delta and rewrites fresh slot rows.
                C = self.cfg.n_channels
                if entry_rel is not None:
                    delta = 0
                    mask = np.ones(C, bool)
                    newsp = entry_rel
                    self._abs_pos = base + entry_rel.astype(np.float64)
                else:
                    delta = self._det_base - base
                    mask = np.zeros(C, bool)
                    newsp = np.zeros(C, np.int64)
                    for i in self._pending_allocs:
                        sp_i = round(self._abs_pos[i] - base)
                        mask[i] = True
                        newsp[i] = sp_i
                        self._abs_pos[i] = base + sp_i
                    self._pending_allocs = []
                # The reader starts on chunk n+1 before superepoch n is
                # dispatched, so that its upload and decode, on the feed
                # stream, can run under superepoch n's kernels.
                det = base + k * espc
                k_next = min(self.sync_every, n_epochs - e - k)
                if k_next > 0:
                    la = 1 if entry_rel is not None else 2
                    nbase = self._next_base(active, la, k, det)
                    nxt = ex.submit(self._prefetch_chunk, nbase, k_next,
                                    (e + k) * self.epoch_ms)
                cur = self._dispatch_superepoch(
                    chunk, k, e, epoch_ms0 >= self._next_reacq_ms, delta,
                    mask, newsp)
                cur.fetch = fx.submit(self._materialize, cur.packed,
                                      cur.acq_fut, epoch_ms0,
                                      cur.kernel_events)
                self._det_base = det
                self._cursor = nbase if k_next > 0 else det
                if pend is not None:
                    self._harvest(pend, next_base=self._cursor,
                                  alloc_ms=(e + k) * self.epoch_ms,
                                  k_ahead=k)
                    self._clock_epochs = e
                pend = cur
                e += k
            if pend is not None:
                self._harvest(pend, next_base=self._cursor,
                              alloc_ms=e * self.epoch_ms)
            self._clock_epochs = e
        finally:
            ex.shutdown(wait=True)
            fx.shutdown(wait=True)

    def _harvest(self, p: _Inflight, next_base: int, alloc_ms: int,
                 k_ahead: int = 0) -> None:
        """Supervise a completed superepoch; drops and reacquisition
        placements take effect at the next dispatch (chunk base
        next_base, first epoch alloc_ms). k_ahead: epochs of the
        superepoch now in flight (0 when draining)."""
        epoch_ms0 = p.e0 * self.epoch_ms
        tlm = self.tlm
        with tlm.span("harvest.wait", se=epoch_ms0) as wait:
            (streams_k, stats_k), acq, timing = p.fetch.result()
        with tlm.span("supervise", se=epoch_ms0) as sv:
            self._stage_health(p, wait.wall_s)
            self._chunk_cache = (p.base, p.buf)
            # Slots allocated since this superepoch was dispatched start
            # at the next one: keep their fresh positions out of its
            # bookkeeping.
            last_ms = (p.e0 + p.k - 1) * self.epoch_ms
            fresh = {i: self._abs_pos[i]
                     for i, s in enumerate(self.slots)
                     if s.state is not SlotState.IDLE
                     and s.started_ms > last_ms}
            pos = self._abs_pos.copy()
            for i, s in enumerate(self.slots):
                if s.state is SlotState.IDLE:
                    pos[i] = p.base
            self._alloc_log = []
            pos = self._supervise_block(streams_k, stats_k, pos, p.e0)
            self._abs_pos = pos
            for i, v in fresh.items():
                self._abs_pos[i] = v
            self._last_progress = time.monotonic()
        tlm.task_health(epoch_ms0, "assess", sv.wall_s)
        self._finish_search(p, acq, alloc_ms, head=next_base)
        allocs = list(self._alloc_log)
        self._alloc_log = None
        self._pending_allocs.extend(allocs)
        # Window budget vs the next dispatch base, predicted forward by the
        # in-flight superepoch's advance.
        if k_ahead > 0:
            adv = k_ahead * self._espc
            for i, s in enumerate(self.slots):
                if (s.state is SlotState.IDLE or i in allocs
                        or s.started_ms > last_ms):
                    continue
                relp = self._abs_pos[i] + adv - next_base
                if relp < 0 or relp > self._drift_margin:
                    self._drop(i, alloc_ms, why="window_overrun")
        tlm.close_span(p.span, **timing)

    # --- host supervision (the reference's, copied) ---

    def _supervise_block(self, streams_k, stats_k, pos, e0: int):
        """Host supervision for K epochs of canonical stream/stat arrays;
        returns the advanced per-slot positions."""
        for j in range(len(stats_k)):
            epoch_ms = (e0 + j) * self.epoch_ms
            st = stats_k[j]
            sj = streams_k[j]
            blk = sj[:, :, self._S_BLK].astype(np.float64)
            ends = pos[None, :] + np.cumsum(blk, axis=0)
            status = tlock.LockStatus(
                cn0_dbhz=st[:, self._T_CN0],
                pll_lock=st[:, self._T_PLL],
                code_lock=st[:, self._T_CODE],
                locked=st[:, self._T_LOCKED] > 0.5)
            dopp_full = sj[:, :, self._S_DOPP]
            self._supervise_epoch(
                epoch_ms, status,
                ip=sj[:, :, self._S_IP], qp=sj[:, :, self._S_QP],
                rem=sj[:, :, self._S_REM], ends=ends,
                dopp_last=dopp_full[-1], dopp_full=dopp_full,
                streams=sj)
            pos = ends[-1]
        return pos

    def _supervise_epoch(self, epoch_ms: int, status, *, ip, qp, rem,
                         ends, dopp_last, dopp_full,
                         streams=None) -> None:
        """Per-epoch host supervision: records, history, confirm/drop
        state machine, navigator poll. Arrays are [E, C] (np)."""
        rec = EpochRecord(
            epoch_ms=epoch_ms,
            prn=np.array([0 if s.started_ms > epoch_ms else s.prn
                          for s in self.slots]),
            cn0_dbhz=np.asarray(status.cn0_dbhz),
            pll_lock=np.asarray(status.pll_lock),
            doppler_hz=np.asarray(dopp_last))
        self.records.append(rec)

        abs_samp = (ends - rem.astype(np.float64)
                    * self.eng.rem_to_samples)
        for i in self._active():
            s = self.slots[i]
            if s.started_ms > epoch_ms:
                # Allocated after this superepoch was dispatched: its row
                # here is pre-handoff garbage; keep it out of history.
                continue
            h = self.history[s.prn]
            h["i_p"].append(ip[:, i].copy())
            h["q_p"].append(qp[:, i].copy())
            if self.eng.has_data_component and streams is not None:
                h["i_p2"].append(streams[:, i, self._S_IP2].copy())
                h["q_p2"].append(streams[:, i, self._S_QP2].copy())
            h["carr_doppler"].append(dopp_full[:, i].copy())
            h["abs_sample"].append(abs_samp[:, i].copy())
            if streams is not None and "_cph" in h:
                h["carr_cycles"].append(h["_cph"].update(
                    dopp_full[:, i], streams[:, i, self._S_BLK]))
            self.tlm.channel_health(
                epoch_ms, i, s.prn, s.state.value,
                float(status.cn0_dbhz[i]), float(dopp_last[i]),
                float(status.pll_lock[i]),
                ip_abs=round(float(np.mean(np.abs(ip[:, i]))), 1),
                qp_abs=round(float(np.mean(np.abs(qp[:, i]))), 1))
            if s.started_ms + self.epoch_ms >= epoch_ms:
                continue          # grace epoch while loops pull in
            if s.state is SlotState.CONFIRM:
                s.confirm_seen += 1
                if status.locked[i]:
                    s.confirm_good += 1
                if s.confirm_good >= self.confirm_m:
                    s.state = SlotState.TRACKING
                    self.tlm.event(epoch_ms, "channel_confirmed",
                                   chan=i, prn=s.prn)
                elif s.confirm_seen >= self.confirm_epochs:
                    self._drop(i, epoch_ms, why="confirm_failed")
                continue
            if not status.locked[i]:
                s.bad_epochs += 1
                if s.bad_epochs >= self.drop_after:
                    self._drop(i, epoch_ms, why="loss_of_lock")
            else:
                s.bad_epochs = 0

        if self.navigator is not None:
            with self.tlm.span("nav.poll") as poll:
                self.navigator.poll(self, epoch_ms)
            self.tlm.task_health(epoch_ms, "pvt", poll.wall_s)
        with self.tlm.span("history.trim"):
            self._trim_history()

    _HIST_LANES = ("i_p", "q_p", "carr_doppler", "abs_sample",
                   "carr_cycles", "i_p2", "q_p2")

    def _trim_history(self) -> None:
        """Evict per-PRN history (whole epoch chunks) and records older
        than history_window_ms; h['evicted'] counts dropped code periods
        so consumers keep absolute indexing."""
        if self.history_window_ms is None:
            return
        wb = self.history_window_ms // self.eng.period_ms
        for s in self.slots:
            h = self.history.get(s.prn) if s.prn else None
            if h is None or not h["i_p"]:
                continue
            total = sum(len(a) for a in h["i_p"])
            while h["i_p"] and total - len(h["i_p"][0]) >= wb:
                n0 = len(h["i_p"][0])
                for k in self._HIST_LANES:
                    if h.get(k):
                        h[k].pop(0)
                h["evicted"] += n0
                total -= n0
        max_rec = max(1, self.history_window_ms // self.epoch_ms)
        if len(self.records) > max_rec:
            del self.records[: len(self.records) - max_rec]

    def _apply_commands(self, epoch_ms: int) -> None:
        """Apply JSON-line runtime commands at the epoch boundary."""
        settable = {"reacq_period_ms": "reacq_period_ms",
                    "cn0_drop": "cn0_drop", "drop_after": "drop_after",
                    "stall_timeout_s": "stall_timeout_s"}
        for c in self.commands.poll():
            cmd = c.get("cmd")
            if cmd == "stop":
                self._stop = True
            elif cmd == "drop":
                for i, s in enumerate(self.slots):
                    if s.state is not SlotState.IDLE \
                            and s.prn == c.get("prn"):
                        self._drop(i, epoch_ms, why="commanded")
            elif cmd == "mask":
                if c.get("prn") in self.pool:
                    self.pool.remove(c["prn"])
                for i, s in enumerate(self.slots):
                    if s.state is not SlotState.IDLE \
                            and s.prn == c.get("prn"):
                        self._drop(i, epoch_ms, why="masked")
            elif cmd == "unmask":
                if c.get("prn") not in self.pool:
                    self.pool.append(c["prn"])
            elif cmd == "set" and c.get("key") in settable:
                v = c.get("v")
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    self.tlm.event(epoch_ms, "command_rejected",
                                   raw=str(c)[:80])
                    continue
                key = settable[c["key"]]
                setattr(self, key,
                        int(v) if key == "drop_after" else float(v))
            else:
                self.tlm.event(epoch_ms, "command_rejected", raw=str(c)[:80])
                continue
            self.tlm.event(epoch_ms, "command_ok", raw=str(c)[:80])

    def _watchdog(self) -> None:
        """A live source that stops producing for stall_timeout_s is
        restarted (recoverable sources) or raises."""
        if time.monotonic() - self._last_progress > self.stall_timeout_s:
            if self._recover_stall(-1):
                return
            self.tlm.event(-1, "watchdog_stall")
            raise TimeoutError(
                f"sample source stalled > {self.stall_timeout_s}s")

    def _recover_stall(self, epoch_ms: int) -> bool:
        """Restart the producer through the source's restart hook,
        re-anchor every channel at the stream head for reacquisition, and
        continue. False = not restartable or restarts keep failing."""
        src = self.source
        if not getattr(src, "can_restart", False):
            return False
        self._consec_restarts += 1
        if self._consec_restarts > 3:
            return False
        self.tlm.event(epoch_ms, "watchdog_restart",
                       attempt=self._consec_restarts)
        src.restart()
        for i, s in enumerate(self.slots):
            if s.state is not SlotState.IDLE:
                self._drop(i, epoch_ms, why="watchdog_restart")
        head = (int(src.position()) if hasattr(src, "position")
                else self._cursor)
        if self.wire is not None:
            head -= head % up.align(self.wire)
        self._cursor = max(self._cursor, head)
        self._abs_pos[:] = self._cursor
        self._next_reacq_ms = max(0, epoch_ms)
        self._last_progress = time.monotonic()
        return True

    # --- checkpoint / warm restart ---

    def save_checkpoint(self, path: str) -> None:
        """Persist the live channel bank (slot assignments, tracking
        state, stream positions) in the reference's file format (npz +
        JSON meta, runtime/checkpoint.py). Each live slot's integer
        carrier-phase accumulator rides along, so integrated carrier
        phase and the absolute block index continue across a restart;
        acc is an exact Python int and travels as a decimal string."""
        from gnsstpu_torch.runtime import checkpoint

        cph = {}
        for s in self.slots:
            if s.state is SlotState.IDLE or s.prn not in self.history:
                continue
            h = self.history[s.prn]
            a = h.get("_cph")
            if a is None:
                continue
            cph[str(s.prn)] = {
                "acc": str(a.acc),
                "last_delta": float(a.last_delta),
                "base": int(a.base),
                "blocks_seen": int(h.get("evicted", 0))
                + sum(len(x) for x in h["i_p"]),
            }

        def to_host(t):
            x = t.detach().cpu().numpy()
            # int64 leaves carry u32 NCO phases.
            return x & U32_MASK if x.dtype == np.int64 else x

        state = (self._state.gather() if isinstance(self._state, Sharded)
                 else self._state)
        checkpoint.save(
            path,
            state=tree_map(to_host, state),
            meta={
                "signal": self.sig.signal,
                "epoch_ms": self.epoch_ms,
                "slots": [[s.state.value, s.prn, s.started_ms]
                          for s in self.slots],
                "abs_pos": [float(v) for v in self._abs_pos],
                "cursor": int(self._cursor),
                "cph": cph,
            })

    def restore_checkpoint(self, path: str) -> dict:
        """Warm-restart from a saved channel bank: slots resume at their
        saved code phases with no reacquisition, and their carrier-phase
        accumulators continue (phase_u32 bit-exact against an
        uninterrupted run). Call before run(); the source must serve the
        saved stream positions. Every state leaf becomes a fresh device
        tensor (split over the mesh when there is one, so a sharded
        manager resumes sharded); u32 leaves ride int64 in [0, 2^32).
        Only a file this
        package wrote is restored: the loader imports every class the
        file names, and a file of the reference receiver names gnsstpu's
        (ValueError)."""
        from gnsstpu_torch.runtime import checkpoint

        with np.load(path, allow_pickle=False) as z:
            payload = json.loads(bytes(z["__meta__"]).decode())
        names = [s[1] for s in payload["spec"] if s[0] == "nt"] + [
            e["__cls__"] for e in payload["ephs"].values()]
        foreign = sorted({n for n in names
                          if n.split(".")[0] != "gnsstpu_torch"})
        if foreign:
            raise ValueError(
                f"checkpoint names classes outside gnsstpu_torch "
                f"({', '.join(foreign)}): not a file this package wrote")
        state, meta, _, _ = checkpoint.load(path)
        if meta.get("signal") != self.sig.signal:
            raise ValueError(
                f"checkpoint is for signal {meta.get('signal')!r}")

        def to_dev(x):
            t = self._put_dev(np.array(x))
            return t & U32_MASK if t.dtype == torch.int64 else t

        self._state = self._shard(tree_map(to_dev, state))
        self._abs_pos = np.asarray(meta["abs_pos"], np.float64)
        self._cursor = int(meta["cursor"])
        for i, (st, prn, _started) in enumerate(meta["slots"]):
            s = self.slots[i]
            s.state = SlotState(st)
            s.prn = int(prn)
            s.bad_epochs = 0
            # Epoch labels restart at 0 in the resumed run.
            s.started_ms = 0
            if s.state is SlotState.IDLE or not s.prn:
                continue
            # The slot's code tables / consts and a fresh history (the
            # saved accumulator and blocks_seen keep carrier phase and
            # the absolute block index continuous across the gap).
            self.eng.write_slot(self._bank, i, s.prn)
            dopp0 = float(state.corr.carr_delta[i]) if hasattr(
                state.corr, "carr_delta") else 0.0
            saved = (meta.get("cph") or {}).get(str(s.prn))
            hist = self._new_history(
                i, start_ms=0,
                doppler_hz=saved["last_delta"] if saved else dopp0,
                evicted=int(saved["blocks_seen"]) if saved else 0)
            if saved:
                hist["_cph"].acc = int(saved["acc"])
                hist["_cph"].base = int(saved["base"])
            self.history[s.prn] = hist
        self._bank_dev = None      # re-upload the rebuilt bank
        return meta

    # --- history accessors ---

    def prompt_stream(self, prn: int) -> dict:
        """Concatenated per-PRN prompt history (np arrays)."""
        h = self.history[prn]
        return {k: (np.concatenate(v) if isinstance(v, list) else v)
                for k, v in h.items() if not k.startswith("_")}
