"""Time-block sharded long coherent acquisition (port of
gnsstpu/parallel/timeblock.py).

A K-code-period coherent correlation is split over the "time" axis of a
mesh, as the reference's shard_map program splits it:

  * each of the B shards holds a contiguous Lb = (K/B)*spc sample block;
  * the overlap-save halo (one code period of the samples after a block)
    is the right neighbour's first spc samples; shard B-1 takes the
    replicated tail after the last block instead;
  * each shard wipes its block with the globally phased carrier (sample
    index b*Lb + m, so there is no phase step at a seam) and correlates it
    with the tiled replica by FFT (torch.fft, complex64);
  * the complex partials are summed across shards before power is formed
    (correlation is linear in the data, so the sum is the full-length
    correlation and keeps the full coherent gain).

The collectives: on a mesh of make_mesh the halo is a device copy and
the sum an ordered sum on the first device; on a mesh of
make_distributed_mesh (a world of one too) the halo of a block whose
right neighbour lies in another process comes from an all-gather of each
rank's first spc samples, and the sum is dist.all_reduce(SUM), on gloo
and on NCCL alike. The reference's fft_mode (its split-complex TPU FFTs,
ops/fftsc.py) has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from gnsstpu_torch.config import SignalConfig
from gnsstpu_torch.device import f32
from gnsstpu_torch.ops import code_tables
from gnsstpu_torch.ops.fft_acquire import next_pow2
from gnsstpu_torch.parallel.mesh import Mesh


def _replica_fd(sig: SignalConfig, prns, kb: int, npad: int) -> np.ndarray:
    """conj(FFT(code tiled kb periods, zero-padded to npad)) per PRN:
    the same rows on every shard (the code is spc-periodic)."""
    table = code_tables.sampled_code_table(
        sig.signal, sig.fs, sig.code_freq, sig.code_length)
    rows = np.stack([table[p - 1] for p in prns]).astype(np.float32)
    tiled = np.zeros((len(prns), npad), np.float32)
    tiled[:, :kb * rows.shape[1]] = np.tile(rows, (1, kb))
    return np.conj(np.fft.fft(tiled, axis=1)).astype(np.complex64)


def _partial(x, halo, b: int, lb: int, fd, dopp, inv_fs: float,
             npad: int, spc: int) -> torch.Tensor:
    """Shard b's complex correlation partial [P, D, spc]."""
    xw = torch.cat([x, halo])                                 # [Lb+spc, 2]
    m = torch.arange(lb + spc, dtype=torch.float32, device=x.device)
    t = (f32(b) * f32(lb) + m) * f32(inv_fs)
    ang = f32(2.0 * np.pi) * dopp[:, None] * t[None, :]       # [D, n]
    lo_c, lo_s = torch.cos(ang), torch.sin(ang)
    xr, xi = xw[:, 0], xw[:, 1]
    w = torch.complex(xr * lo_c + xi * lo_s, xi * lo_c - xr * lo_s)
    f = torch.fft.fft(w, n=npad, dim=-1)                      # [D, npad]
    return torch.fft.ifft(f[None] * fd[:, None], dim=-1)[..., :spc]


def long_coherent_acquire(samples_iq: np.ndarray, sig: SignalConfig, prns,
                          doppler_hz: np.ndarray, mesh: Mesh, *,
                          k_periods: int,
                          axis: str = "time") -> torch.Tensor:
    """Coherent K-code-period correlation power, time-sharded.

    samples_iq: f32 [>= K*spc + spc, 2] leading samples (every process of
      a distributed mesh passes the same); prns: PRNs to search;
    doppler_hz: [D] absolute carrier frequencies; mesh: a mesh with an
      `axis` of size B (K must divide by B); k_periods: K.
    Returns f32 [P, D, spc] coherent power on this process's first mesh
    device (peak_metrics applies unchanged).
    """
    spc = sig.samples_per_code
    B = mesh.shape[axis]
    if k_periods % B:
        raise ValueError(f"k_periods {k_periods} not divisible by B={B}")
    kb = k_periods // B
    lb = kb * spc
    need = k_periods * spc + spc
    if samples_iq.shape[0] < need:
        raise ValueError(f"need >= {need} samples")
    npad = next_pow2(lb + spc)
    blocks = np.asarray(samples_iq[:B * lb], np.float32).reshape(B, lb, 2)
    tail = np.asarray(samples_iq[B * lb:B * lb + spc], np.float32)
    fd_np = _replica_fd(sig, prns, kb, npad)
    dopp_np = np.asarray(doppler_hz, np.float32)

    pos = mesh.axis_positions(axis)
    mine = [b for b in range(B) if mesh.local(pos[b])]
    devs = {b: mesh.devices[pos[b]] for b in mine}
    x = {b: torch.as_tensor(blocks[b], device=devs[b]) for b in mine}
    heads = _halo_heads(x, mine, pos, mesh, spc) if mesh.distributed \
        else None
    first = mesh.first_device
    total = None
    for b in mine:
        dev = devs[b]
        if b == B - 1:
            halo = torch.as_tensor(tail, device=dev)
        elif b + 1 in x:
            halo = x[b + 1][:spc].to(dev)                 # device copy
        else:
            halo = heads[int(mesh.owners[pos[b + 1]])].to(dev)
        part = _partial(x[b], halo, b, lb,
                        torch.as_tensor(fd_np, device=dev),
                        torch.as_tensor(dopp_np, device=dev), 1.0 / sig.fs,
                        npad, spc).to(first)
        total = part if total is None else total + part
    if mesh.distributed:
        import torch.distributed as dist

        acc = torch.view_as_real(total).contiguous()
        dist.all_reduce(acc, op=dist.ReduceOp.SUM)
        total = torch.view_as_complex(acc)
    return total.real * total.real + total.imag * total.imag


def _halo_heads(x: dict, mine: list, pos: list, mesh: Mesh,
                spc: int) -> list:
    """Every rank's first local block's first spc samples (all_gather,
    which gloo and NCCL both have), indexed by rank. A rank's shards must
    be contiguous along the axis, in rank order."""
    import torch.distributed as dist

    owners = [int(mesh.owners[p]) for p in pos]
    if owners != sorted(owners):
        raise ValueError("each rank's time shards must be contiguous and "
                         "in rank order")
    head = x[mine[0]][:spc].contiguous()
    got = [torch.empty_like(head) for _ in range(dist.get_world_size())]
    dist.all_gather(got, head)
    return got


def reference_coherent_power(samples_iq: np.ndarray, sig: SignalConfig,
                             prns, doppler_hz: np.ndarray,
                             k_periods: int) -> np.ndarray:
    """Single-device NumPy oracle for long_coherent_acquire (same math,
    no sharding): f64 [P, D, spc]. Copied from
    gnsstpu.parallel.timeblock."""
    spc = sig.samples_per_code
    L = k_periods * spc
    x = samples_iq[: L + spc]
    xc = x[:, 0].astype(np.float64) + 1j * x[:, 1]
    table = code_tables.sampled_code_table(
        sig.signal, sig.fs, sig.code_freq, sig.code_length)
    npad = next_pow2(L + spc)
    out = np.zeros((len(prns), len(doppler_hz), spc))
    t = np.arange(L + spc) / sig.fs
    for pi_, p in enumerate(prns):
        code = np.tile(table[p - 1].astype(np.float64), k_periods)
        fd = np.conj(np.fft.fft(code, npad))
        for di, f in enumerate(doppler_hz):
            w = xc * np.exp(-2j * np.pi * f * t)
            c = np.fft.ifft(np.fft.fft(w, npad) * fd)[:spc]
            out[pi_, di] = np.abs(c) ** 2
    return out
