"""Device meshes and sharded values for the receiver's two parallel axes
(port of gnsstpu/parallel/mesh.py).

  * "channel" axis: tracking channels are independent, so the state
    NamedTuple's [C]-leading leaves and the code tables split along C,
    one slice per shard, and the sample chunk is replicated; the steady
    state needs no collective (parallel.fused_shard);
  * "doppler" axis: acquisition's (PRN x Doppler x code-phase) cube
    splits over PRNs and Doppler bins, each shard computing its sub-cube
    on its device, and the cube is assembled on the mesh's first device
    (ops.fft_acquire.acquire_cube).

The reference annotates inputs with NamedSharding and lets XLA partition
one program (GSPMD). PyTorch has no such partitioner, so the port holds a
split value as a Sharded (one part per shard, each on its shard's
device) or a Replicated (one copy per distinct device) and runs each
shard's work itself.

A mesh is a named grid of torch.device. Devices may repeat: the CPU
tests run an 8-way mesh on devices=["cpu"] * 8 (the counterpart of XLA's
host-platform virtual devices), and one card holds a 2- or 4-way mesh,
its shards then launching on streams of their own. make_mesh never falls
back to the CPU: with fewer cards than shards it shares the cards
round-robin and warns, and with no card it raises.
make_distributed_mesh spans processes over torch.distributed (NCCL on
the card, gloo on the CPU), for the time-sharded long coherent search
(parallel.timeblock).
"""

from __future__ import annotations

import itertools
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gnsstpu_torch.device import resolve_device


class Mesh:
    """A named grid of devices.

    devices: object ndarray of torch.device, of the mesh's shape;
    axis_names: one name per dimension; owners: int ndarray of the same
    shape, the torch.distributed rank that holds each position (all 0
    for a mesh of one process); rank: this process's rank; distributed:
    built by make_distributed_mesh, so collectives run through the
    torch.distributed process group, in a world of one too.
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 owners: Optional[np.ndarray] = None, rank: int = 0,
                 distributed: bool = False):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.owners = (np.zeros(devices.shape, np.int64) if owners is None
                       else owners)
        self.rank = rank
        self.distributed = distributed

    @property
    def shape(self) -> dict:
        """{axis name: size}, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first_device(self) -> torch.device:
        """This process's first device: where whole-bank results are
        assembled."""
        return self.devices[self.owners == self.rank].flat[0]

    def axis_positions(self, axis: str) -> list:
        """Mesh indices along `axis`, every other axis at index 0: the
        shards of a value split over `axis` alone."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}")
        ax = self.axis_names.index(axis)
        return [tuple(i if d == ax else 0 for d in range(self.devices.ndim))
                for i in range(self.devices.shape[ax])]

    def axis_devices(self, axis: str) -> list:
        return [self.devices[p] for p in self.axis_positions(axis)]

    def local(self, pos: tuple) -> bool:
        return int(self.owners[pos]) == self.rank

    def distinct_devices(self) -> list:
        """This process's devices, each once, in mesh order."""
        out = []
        for d, r in zip(self.devices.flat, self.owners.flat):
            if r == self.rank and d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(axis_sizes: Sequence[Tuple[str, int]],
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh, e.g. make_mesh([("channel", 2), ("doppler", 4)]).

    devices: the mesh's devices in row-major order; they may repeat (a
    CUDA device needs a card, else this raises). The default is cuda:0
    ... cuda:n-1; with fewer cards than shards the shards share the
    cards round-robin, with a RuntimeWarning naming the sharing, and with
    no card it raises: unlike the reference, there is no CPU fallback.
    """
    names = tuple(n for n, _ in axis_sizes)
    shape = tuple(int(s) for _, s in axis_sizes)
    n = int(np.prod(shape))
    if devices is None:
        resolve_device("cuda")            # raises without a card
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(n)]
        if count < n:
            shared = {str(d): [i for i in range(n) if devices[i] == d]
                      for d in devices[:count]}
            warnings.warn(
                f"make_mesh: {n} shards on {count} card(s); shards share "
                f"cards round-robin ({shared}), each launching on its own "
                "stream", RuntimeWarning, stacklevel=2)
    devices = [resolve_device(d) for d in list(devices)[:n]]
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), names)


def make_distributed_mesh(axis_sizes: Sequence[Tuple[str, int]],
                          coordinator: Optional[str] = None,
                          num_processes: Optional[int] = None,
                          process_id: Optional[int] = None,
                          devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over the devices of several processes: each process calls this
    with the same coordinator ('HOST:PORT', a TCP store on rank 0),
    num_processes and its own process_id, and contributes its local
    devices (default: cuda:(process_id % cards)). The process group uses
    NCCL when the local device is CUDA and gloo on the CPU; the mesh's
    positions are filled in rank order. With coordinator=None this is
    make_mesh(axis_sizes, devices), as in the reference.

    NCCL refuses two ranks on one card, so a one-card host runs a world
    of one."""
    import torch.distributed as dist

    if coordinator is None:
        return make_mesh(axis_sizes, devices)
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda",
                                process_id % torch.cuda.device_count())]
    local = [resolve_device(d) for d in devices]
    if local[0].type == "cuda":
        torch.cuda.set_device(local[0])
    dist.init_process_group(
        "nccl" if local[0].type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id)
    every: list = [None] * num_processes
    dist.all_gather_object(every, [str(d) for d in local])
    flat = [(torch.device(d), r) for r, ds in enumerate(every) for d in ds]
    names = tuple(n for n, _ in axis_sizes)
    shape = tuple(int(s) for _, s in axis_sizes)
    if len(flat) != int(np.prod(shape)):
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{int(np.prod(shape))} devices, the world has "
                         f"{len(flat)}")
    devs = np.empty(len(flat), dtype=object)
    devs[:] = [d for d, _ in flat]
    owners = np.array([r for _, r in flat], np.int64)
    return Mesh(devs.reshape(shape), names, owners.reshape(shape),
                rank=process_id, distributed=True)


# --- sharded values -------------------------------------------------------

def tree_map(fn, *trees):
    """fn leafwise over (nested) NamedTuples and tuples; None stays."""
    head = trees[0]
    if head is None:
        return None
    if isinstance(head, tuple):
        parts = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(head)(*parts) if hasattr(head, "_fields") \
            else tuple(parts)
    return fn(*trees)


def to_device(x, device: torch.device) -> torch.Tensor:
    """Host array or tensor -> tensor on device (uint32 rides int64)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.as_tensor(x, device=device)


class Sharded:
    """A [C]-leading value (a tensor or a NamedTuple of them) split along
    dim 0 over mesh[axis]: parts[i] holds rows [i*C/N, (i+1)*C/N) on
    mesh.axis_devices(axis)[i]."""

    def __init__(self, mesh: Mesh, axis: str, parts: Sequence):
        self.mesh = mesh
        self.axis = axis
        self.parts = tuple(parts)

    def rows(self, i: int) -> slice:
        """Rows of the whole value that part i holds."""
        n = len(tree_leaves(self.parts[0])[0])
        return slice(i * n, (i + 1) * n)

    def map(self, fn) -> "Sharded":
        """fn(part, rows) on every part, as a new Sharded."""
        return Sharded(self.mesh, self.axis,
                       [fn(p, self.rows(i)) for i, p in
                        enumerate(self.parts)])

    def gather(self, device=None):
        """The whole value on `device` (default: the mesh's first)."""
        dev = device or self.mesh.first_device
        return tree_map(lambda *xs: torch.cat([x.to(dev) for x in xs]),
                        *self.parts)

    def __repr__(self) -> str:
        return (f"Sharded(axis={self.axis!r}, devices="
                f"{[str(d) for d in self.mesh.axis_devices(self.axis)]})")


class Replicated(dict):
    """One copy of a tensor per distinct device: {torch.device: tensor}."""

    def on(self, device: torch.device) -> torch.Tensor:
        return self[device]

    def map(self, fn) -> "Replicated":
        return Replicated({d: fn(t) for d, t in self.items()})


def tree_leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def shard_rows(x, mesh: Mesh, axis: str = "channel") -> Sharded:
    """Split a [C]-leading tensor, host array or NamedTuple of either
    along C over mesh[axis], each part on its shard's device; C must
    divide by the axis size."""
    devs = mesh.axis_devices(axis)
    C = len(tree_leaves(x)[0])
    if C % len(devs):
        raise ValueError(f"{C} rows not divisible by mesh axis {axis!r} "
                         f"size {len(devs)}")
    n = C // len(devs)
    return Sharded(mesh, axis, [
        tree_map(lambda t: to_device(t[i * n:(i + 1) * n], d), x)
        for i, d in enumerate(devs)])


def replicate(x, mesh: Mesh) -> Replicated:
    """A copy of x on each of this process's distinct mesh devices (the
    tensor itself where it already lies)."""
    return Replicated({d: to_device(x, d) for d in mesh.distinct_devices()})


def shard_channel_state(state, codes, mesh: Mesh, axis: str = "channel"):
    """Tracking state ([C]-leaved NamedTuple) and code table [C, ...]
    split over `axis`; C must divide by the axis size."""
    return shard_rows(state, mesh, axis), shard_rows(codes, mesh, axis)


class AcqShards:
    """Acquisition inputs placed on a mesh: cells[(i, j)] = (device,
    blocks, code_fd rows of PRN shard i, Doppler bins of shard j), every
    tensor on that cell's device."""

    def __init__(self, mesh: Mesh, cells: dict, n_prn: int, n_dopp: int):
        self.mesh = mesh
        self.cells = cells
        self.shape = (n_prn, n_dopp)


def shard_acquisition_inputs(blocks_iq, code_fd, doppler, mesh: Mesh,
                             prn_axis: str = "channel",
                             doppler_axis: str = "doppler") -> AcqShards:
    """Place acquisition inputs: sample windows replicated, code spectra
    (complex [P, Npad]) split over PRNs along prn_axis, the Doppler grid
    [D] split along doppler_axis (an axis the mesh lacks is size 1).
    Every cell of the two axes gets its tensors on its own device; other
    axes take index 0. P and D must divide by their axis sizes."""
    shape = mesh.shape
    n_p, n_d = shape.get(prn_axis, 1), shape.get(doppler_axis, 1)
    P, D = code_fd.shape[0], doppler.shape[0]
    if P % n_p or D % n_d:
        raise ValueError(f"{P} PRNs x {D} bins do not split {n_p} x {n_d}")
    pp, dd = P // n_p, D // n_d
    blocks = replicate(blocks_iq, mesh)
    cells = {}
    for i, j in itertools.product(range(n_p), range(n_d)):
        pos = tuple(i if a == prn_axis else j if a == doppler_axis else 0
                    for a in mesh.axis_names)
        dev = mesh.devices[pos]
        cells[(i, j)] = (dev, blocks.on(dev),
                         to_device(code_fd[i * pp:(i + 1) * pp], dev),
                         to_device(doppler[j * dd:(j + 1) * dd], dev))
    return AcqShards(mesh, cells, n_p, n_d)
