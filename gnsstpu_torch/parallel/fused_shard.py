"""Channel-sharded tracking: one K1 launch per shard (port of
gnsstpu/parallel/fused_shard.py).

K1 (ops.track_kernel, one CTA per channel) has nothing in it that
depends on C, so channel parallelism runs the same kernel on every shard
of mesh["channel"] over its channel slice, the sample chunk replicated,
with no collective in steady state (channels are independent). The
reference wraps its Pallas kernel in shard_map; here shard_tracker runs
each shard's tracker on its shard's device and assembles the per-block
outputs along C on the mesh's first device, in the reference's layout
P(None, axis): [n_blocks, C].

Shards that share a card each launch on a CUDA stream of their own, so
their CTAs run together: each stream first waits for its device's
current stream (the chunk and the state it reads), and that current
stream waits for it before anything reads the outputs. Work on other
streams therefore never overlaps a shard's, so the caching allocator's
blocks stay safe without record_stream. On the CPU the shards run one
after another through the kernel's plain twin.
"""

from __future__ import annotations

import contextlib

import torch

from gnsstpu_torch.config import SignalConfig, TrackConfig
from gnsstpu_torch.parallel.mesh import (Mesh, Replicated, Sharded,
                                         replicate, shard_rows, tree_map)
from gnsstpu_torch.tracking.fused import make_fused_tracker


def shard_fused_inputs(state, tab, consts, chunk, mesh: Mesh,
                       axis: str = "channel"):
    """Place fused-tracker inputs: the state NamedTuple's [C]-leaves, the
    tap table [C, R, bp] and each of consts split over `axis`; the chunk
    replicated, one copy per distinct device."""
    return (shard_rows(state, mesh, axis), shard_rows(tab, mesh, axis),
            tuple(shard_rows(c, mesh, axis) for c in consts),
            replicate(chunk, mesh))


def _shard_arg(a, i: int, dev: torch.device):
    """Shard i's view of one tracker argument."""
    if isinstance(a, Sharded):
        return a.parts[i]
    if isinstance(a, Replicated):
        return a.on(dev)
    if isinstance(a, tuple) and not hasattr(a, "_fields"):
        return tuple(_shard_arg(x, i, dev) for x in a)
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return a


def shard_tracker(inner, mesh: Mesh, axis: str = "channel"):
    """Wrap a tracker inner(*args) -> (state, out) to run per shard of
    mesh[axis]: a Sharded argument gives each shard its part, a
    Replicated its device's copy, a tensor is moved to the shard's
    device. Returns (state as a Sharded, out gathered along C: every
    [n_blocks, C] leaf concatenated on dim 1 on the mesh's first
    device)."""
    if mesh.distributed:
        raise ValueError("shard_tracker runs the shards of one process; "
                         "a mesh of make_distributed_mesh is for "
                         "parallel.timeblock")
    devs = mesh.axis_devices(axis)
    first = mesh.first_device
    streams: dict = {}

    def stream_of(i: int, dev: torch.device):
        if dev.type != "cuda":
            return contextlib.nullcontext(), None
        if i not in streams:
            streams[i] = torch.cuda.Stream(device=dev)
        s = streams[i]
        s.wait_stream(torch.cuda.current_stream(dev))
        return torch.cuda.stream(s), s

    def track_chunk(*args):
        results, used = [], []
        for i, dev in enumerate(devs):
            ctx, s = stream_of(i, dev)
            with ctx:
                results.append(inner(*(_shard_arg(a, i, dev)
                                       for a in args)))
            if s is not None:
                used.append((dev, s))
        for dev, s in used:
            torch.cuda.current_stream(dev).wait_stream(s)
        state = Sharded(mesh, axis, [st for st, _ in results])
        out = tree_map(lambda *xs: torch.cat([x.to(first) for x in xs],
                                             dim=1),
                       *[o for _, o in results])
        return state, out

    return track_chunk


def make_sharded_fused_tracker(sig: SignalConfig, trk: TrackConfig, *,
                               mesh: Mesh, n_blocks: int,
                               axis: str = "channel"):
    """track_chunk(chunk, tab, consts, state) running K1 (its twin on CPU
    devices) on every shard of mesh[axis] over its channel slice, inputs
    as shard_fused_inputs places them. The per-shard channel count is
    C / mesh.shape[axis] (the ChannelManager checks that it divides)."""
    return shard_tracker(
        make_fused_tracker(sig, trk, n_blocks=n_blocks),
        mesh, axis)
