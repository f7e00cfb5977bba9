"""The live receiver's per-epoch lock summary and readback packing
(ChannelManager's summary path) in one hand-written CUDA kernel,
csrc/epoch_summary.cu, launched once per supervision epoch.

It replaces no Pallas kernel: gnsstpu computes this summary with XLA ops
under jit (gnsstpu/runtime/manager.py ChannelManager._make_summarize and
its `pack`), which XLA fuses. Run as plain PyTorch on an H100 the same
function was 63 ops an epoch (tracking.lock.assess_device and the compact
lanes) and 10 more a superepoch (the stack / cat of the readback), each a
kernel of 1.5-2.5 us: a traced window of the live GPS receiver spent ~1.5
s of its ~6.3 s of device time in such small kernels. The work is ~0.29
MB read and written an epoch at C = 12 channels x E = 500 blocks, 0.09 us
at 3.35 TB/s; what bounds the kernel is one launch and the latency of one
reduction (see the note in the source).

Readback layouts (K epochs of E blocks and C channels, as
ChannelManager._decode_readback reads them):
  compact  one uint8 buffer: pp f16 [K,E,C,P] | rem u16 [K,E,C] |
           blkd i16 [K,E,C] | dopp f32 [K,E,C] | st f32 [K,C,4];
           P = 2 prompts (+2 data prompts for a dual-component engine)
  f32      streams f32 [K,E,C,5(+2)] and st f32 [K,C,4], two views of one
           buffer
Stream lanes: ip, qp, rem, blksize, Doppler (+ ip2, qp2); stats lanes:
C/N0 (dB-Hz), PLL lock, code lock, locked (1.0 or 0.0).

new_readback allocates a superepoch's buffer (one torch.empty) and
epoch_summary fills epoch slot k of it. Both check dtypes, shapes and
devices on every device; CPU tensors then run the plain version
(summary_plain, written into the slot by fill_plain), CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import itertools

import torch

from gnsstpu_torch.device import f32
from gnsstpu_torch.tracking import lock as tlock

SOURCE = "epoch_summary.cu"
#: Kernel launches since the last reset (plain count; CPU runs of the
#: plain version are not launches). track_kernel.reset_launches() zeroes
#: it with K1-K3's counts.
LAUNCHES = {"epoch_summary": 0}
#: The f32 observables in the order the kernel takes them (then ip2, qp2).
F32_LANES = ("ie", "qe", "ip", "qp", "il", "ql", "rem", "dopp")
#: PLL lock a channel needs to count as locked (assess_device's pll_min).
PLL_MIN = 0.5


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def n_prompts(dual: bool) -> int:
    """Prompts per block and channel in the compact buffer."""
    return 4 if dual else 2


def n_lanes(dual: bool) -> int:
    """Stream lanes per block and channel in the f32 readback."""
    return 7 if dual else 5


def compact_sizes(K: int, E: int, C: int, dual: bool) -> tuple:
    """Bytes of the compact buffer's regions: pp, rem, blkd, dopp, st."""
    n = K * E * C
    return (n * n_prompts(dual) * 2, n * 2, n * 2, n * 4, K * C * 16)


def new_readback(K: int, E: int, C: int, *, dual: bool, compact: bool,
                 device) -> list:
    """A K-epoch readback buffer, uninitialised: [one uint8 buffer]
    (compact) or [streams, stats] (f32, views of one buffer)."""
    if compact:
        return [torch.empty(sum(compact_sizes(K, E, C, dual)),
                            dtype=torch.uint8, device=device)]
    L = n_lanes(dual)
    buf = torch.empty(K * C * (E * L + 4), dtype=torch.float32,
                      device=device)
    n = K * E * C * L
    return [buf[:n].view(K, E, C, L), buf[n:].view(K, C, 4)]


def compact_views(buf: torch.Tensor, K: int, E: int, C: int,
                  dual: bool) -> tuple:
    """The compact buffer's regions as typed views: pp f16 [K,E,C,P],
    rem i16 [K,E,C] (the u16 bits), blkd i16 [K,E,C], dopp f32 [K,E,C],
    st f32 [K,C,4]."""
    o = list(itertools.accumulate((0,) + compact_sizes(K, E, C, dual)))
    dtypes = (torch.float16, torch.int16, torch.int16, torch.float32,
              torch.float32)
    shapes = ((K, E, C, n_prompts(dual)), (K, E, C), (K, E, C), (K, E, C),
              (K, C, 4))
    return tuple(buf[a:b].view(dt).view(shape) for a, b, dt, shape
                 in zip(o[:-1], o[1:], dtypes, shapes))


def summary_plain(obs, *, m: int, t_int_s: float, cn0_drop_dbhz: float,
                  spc: int, compact: bool) -> tuple:
    """One epoch's summary in plain PyTorch, on any device: lock stats
    [C, 4] from assess_device plus the per-block streams, as f32 lanes
    (streams [E, C, 5(+2)], st) or (compact) f16 prompts scaled by 1/spc
    [E, C, P], rem as u16 fixed point over [0, 1) chips in int32, i16
    blksize - spc, f32 Doppler, st."""
    dual = obs.ip2 is not None
    stats = tlock.assess_device(
        obs.ie, obs.qe, obs.ip, obs.qp, obs.il, obs.ql, t_int_s=t_int_s,
        cn0_drop_dbhz=cn0_drop_dbhz, pll_min=PLL_MIN, m=m)
    st = torch.stack(
        [stats["cn0_dbhz"], stats["pll_lock"], stats["code_lock"],
         stats["locked"].to(torch.float32)], dim=-1)        # [C, 4]
    if compact:
        # Prompts scaled by 1/spc (f16 cannot overflow); rem as u16
        # fixed point over [0, 1) chips (~4 mm).
        scale = f32(1.0 / spc)
        rem_u16 = torch.clamp(torch.round(obs.rem * 65535.0),
                              0, 65535).to(torch.int32)
        pp = [obs.ip, obs.qp] + ([obs.ip2, obs.qp2] if dual else [])
        return (torch.stack([p * scale for p in pp],
                            dim=-1).to(torch.float16),
                rem_u16,
                (obs.blksize - spc).to(torch.int16),
                obs.dopp, st)
    lanes = [obs.ip, obs.qp, obs.rem, obs.blksize.to(torch.float32),
             obs.dopp]
    if dual:
        lanes += [obs.ip2, obs.qp2]
    return torch.stack(lanes, dim=-1), st                   # [E, C, 5(+2)]


def fill_plain(obs, out: list, k: int, **kw) -> None:
    """Epoch slot k of `out` from summary_plain's lanes (kw: its
    arguments but compact), on any device."""
    E, C, K, dual, compact = _check(obs, out, k, kw["m"])
    lanes = summary_plain(obs, compact=compact, **kw)
    if compact:
        pp, rem, blkd, dopp, st = lanes
        rem16 = torch.where(rem >= 32768, rem - 65536, rem).to(torch.int16)
        lanes = (pp, rem16, blkd, dopp, st)
        out = compact_views(out[0], K, E, C, dual)
    for view, lane in zip(out, lanes):
        view[k] = lane


def _check_tensor(name, t, dtype, shape, dev, contiguous: bool) -> None:
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(obs, out: list, k: int, m: int) -> tuple:
    """The summary's argument checks, the same on every device. Returns
    (E, C, K, dual, compact)."""
    dev = obs.ip.device
    if obs.ip.dim() != 2:
        raise ValueError(f"ip shape {tuple(obs.ip.shape)}, expected [E, C]")
    E, C = obs.ip.shape
    dual = obs.ip2 is not None
    if (obs.qp2 is not None) != dual:
        raise ValueError("ip2 and qp2: both or neither")
    for name in F32_LANES + (("ip2", "qp2") if dual else ()):
        _check_tensor(name, getattr(obs, name), torch.float32, (E, C), dev,
                      False)
    _check_tensor("blksize", obs.blksize, torch.int32, (E, C), dev, False)
    if not 1 <= m <= E:
        raise ValueError(f"m {m} outside [1, E = {E}]")
    compact = len(out) == 1
    if compact:
        per_k = sum(compact_sizes(1, E, C, dual))
        K = out[0].numel() // per_k
        _check_tensor("readback", out[0], torch.uint8, (K * per_k,), dev,
                      True)
    elif len(out) == 2:
        K = out[0].shape[0]
        _check_tensor("streams", out[0], torch.float32,
                      (K, E, C, n_lanes(dual)), dev, True)
        _check_tensor("stats", out[1], torch.float32, (K, C, 4), dev, True)
    else:
        raise ValueError(f"readback of {len(out)} tensors: one (compact) "
                         "or two (streams, stats)")
    if not 0 <= k < K:
        raise ValueError(f"epoch slot {k} outside a readback of {K}")
    return E, C, K, dual, compact


def _lib():
    from gnsstpu_torch.ops import cuda_build

    built = cuda_build.load(SOURCE)
    fn = built.lib.epoch_summary_cuda
    if not fn.argtypes:
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([p, p, p, ctypes.c_longlong, ctypes.c_longlong]
                       + [i] * 6 + [fl] * 4 + [i] + [p] * 7)
        fn.restype = ctypes.c_int
        info = built.lib.epoch_summary_info
        info.argtypes = [p]
        info.restype = ctypes.c_int
        err = built.lib.epoch_summary_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built


def summary_info() -> dict:
    """What the kernel uses: registers, static shared and local bytes and
    threads per CTA (one CTA per channel)."""
    lib = _lib().lib
    info = (ctypes.c_int * 4)()
    rc = lib.epoch_summary_info(ctypes.addressof(info))
    if rc != 0:
        raise RuntimeError(
            "epoch_summary_info: "
            + lib.epoch_summary_error_string(rc).decode())
    return dict(registers=info[0], static_smem=info[1],
                local_bytes=info[2], threads=info[3])


def _launch(obs, out: list, k: int, E: int, C: int, K: int, dual: bool,
            compact: bool, *, m: int, t_int_s: float, cn0_drop_dbhz: float,
            spc: int) -> None:
    """One launch of the kernel on CUDA tensors already checked."""
    dev = obs.ip.device
    lanes = [getattr(obs, n) for n in F32_LANES]
    lanes += [obs.ip2, obs.qp2] if dual else [None, None]
    ptrs = (ctypes.c_void_p * len(lanes))(
        *(None if t is None else t.data_ptr() for t in lanes))
    strides = (ctypes.c_longlong * (2 * len(lanes)))(
        *(s for t in lanes for s in ((0, 0) if t is None else t.stride())))
    if compact:
        base = out[0].data_ptr()
        if base % 16:
            raise ValueError("readback must be 16-byte aligned")
        o = list(itertools.accumulate((0,) + compact_sizes(K, E, C, dual)))
        regions = [base + x for x in o[:4]] + [None, base + o[4]]
    else:
        regions = [None] * 4 + [out[0].data_ptr(), out[1].data_ptr()]
    blk = obs.blksize
    built = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = built.lib.epoch_summary_cuda(
            ptrs, strides, blk.data_ptr(), blk.stride(0), blk.stride(1),
            E, C, m, K, k, spc, f32(1.0 / spc), t_int_s, cn0_drop_dbhz,
            PLL_MIN, int(compact), *regions, stream)
    if rc != 0:
        msg = built.lib.epoch_summary_error_string(rc).decode()
        raise RuntimeError(f"epoch_summary launch failed: {msg} ({rc})")


def epoch_summary(obs, out: list, k: int, *, m: int, t_int_s: float,
                  cn0_drop_dbhz: float, spc: int) -> bool:
    """Fill epoch slot k of a superepoch's readback `out` (new_readback's
    list) from one epoch's observables `obs` (tracking.engines.EpochObs:
    [E, C] tensors with any strides, f32 but blksize int32; ip2 and qp2
    both or neither). m: blocks per NWPR group; t_int_s: a block's
    coherent time; spc: the nominal samples per block.

    Checks dtypes, shapes and devices on every device. CPU tensors run
    the plain version and return False; CUDA tensors launch the kernel
    (on torch.cuda.current_stream()) and return True, or raise.
    """
    E, C, K, dual, compact = _check(obs, out, k, m)
    kw = dict(m=m, t_int_s=t_int_s, cn0_drop_dbhz=cn0_drop_dbhz, spc=spc)
    dev = obs.ip.device
    if dev.type == "cpu":
        fill_plain(obs, out, k, **kw)
        return False
    if dev.type != "cuda":
        raise ValueError(f"epoch_summary: unsupported device {dev}")
    _launch(obs, out, k, E, C, K, dual, compact, **kw)
    LAUNCHES["epoch_summary"] += 1
    return True
