"""Pinned staging for the sample feed: a host-resident chunk crosses to a
card through a small ring of page-locked buffers, copied on a CUDA stream
of the feed's own.

A copy from pageable host memory is staged by the CUDA runtime through a
bounce buffer of its own, piece by piece behind the host's copy into it,
and holds the copy engine for all of it (~6 GB/s on an H100's link); a
copy from page-locked memory runs at the link's speed and may overlap the
kernels of other streams.

StagingRing.upload copies the chunk into a free slot on the host, issues
the slot's copy to the card (and the decode the caller hands it) on the
ring's stream, and records an event there behind both, tied to the slot.
The stream that reads the result waits on that event on the card
(consume), never on the host. A slot is refilled only once the event of
its last copy has completed: the host waits for it only where the ring
has wrapped onto a copy still in flight.

Rings are kept for the process by (device, slot bytes), so a receiver
built anew for every run (each cold start) pays the page-locked
allocation once.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Tuple

import torch

#: Slots a ring holds: the chunk the card is reading, the one being
#: uploaded behind it, and one more for the host to fill.
SLOTS = 3

#: StagingRing by (device, slot bytes), each made at its first use.
_RINGS: dict = {}
_RINGS_LOCK = threading.Lock()


class StagingRing:
    """SLOTS page-locked host buffers of slot_bytes each and the CUDA
    stream that copies out of them to `device`. Thread-safe."""

    def __init__(self, device: torch.device, slot_bytes: int):
        self.device = device
        self.slot_bytes = slot_bytes
        self.stream = torch.cuda.Stream(device)
        self._slots = [torch.empty(slot_bytes, dtype=torch.uint8,
                                   pin_memory=True) for _ in range(SLOTS)]
        self._done = [None] * SLOTS     # event behind each slot's last copy
        self._next = 0
        self._lock = threading.Lock()

    def upload(self, host: torch.Tensor,
               decode: Optional[Callable] = None
               ) -> Tuple[torch.Tensor, torch.cuda.Event, int]:
        """host (a contiguous CPU tensor of at most slot_bytes) through
        the next slot to the device, then decode(device tensor) on the
        ring's stream. Returns (the result, the event its readers' stream
        waits on, 1 if the host waited for the slot's last copy else
        0)."""
        if host.nbytes > self.slot_bytes:
            raise ValueError(f"{host.nbytes} bytes exceed the ring's "
                             f"{self.slot_bytes}-byte slots")
        with self._lock:
            i = self._next
            self._next = (i + 1) % SLOTS
            waited = 0
            last = self._done[i]
            if last is not None and not last.query():
                last.synchronize()
                waited = 1
            slot = self._slots[i][:host.nbytes].view(host.dtype).view(
                host.shape)
            slot.copy_(host)
            with torch.cuda.stream(self.stream):
                out = slot.to(self.device, non_blocking=True)
                if decode is not None:
                    out = decode(out)
                ready = torch.cuda.Event()
                ready.record(self.stream)
            self._done[i] = ready
        return out, ready, waited


def ring(device, slot_bytes: int) -> StagingRing:
    """The process's ring for (device, slot_bytes), made at first use."""
    key = (torch.device(device), int(slot_bytes))
    r = _RINGS.get(key)
    if r is None:
        with _RINGS_LOCK:
            r = _RINGS.get(key)
            if r is None:
                r = _RINGS[key] = StagingRing(key[0], key[1])
    return r


def consume(dev: Optional[torch.Tensor],
            ready: Optional[torch.cuda.Event]) -> Optional[torch.Tensor]:
    """Before the current stream of dev's device reads an uploaded dev:
    that stream waits on the card for the upload's ready event, and the
    caching allocator learns that it reads dev (dev was allocated on the
    ring's stream, and its memory must not go back to that stream while
    this one still reads it). ready None (nothing staged): nothing to
    do. Returns dev."""
    if ready is not None:
        stream = torch.cuda.current_stream(dev.device)
        stream.wait_event(ready)
        dev.record_stream(stream)
    return dev
