"""The fused tracking kernels (port of gnsstpu/ops/track_kernel.py).

K1 `track_chunk_fused` (single-code DLL / FLL-assisted PLL: GPS L1 C/A,
GLONASS L1/L2 OF, BeiDou B1I), K2 `track_chunk_boc_fused` (the Galileo
E1B BOC(1,1) double estimator) and K3 `track_chunk_dual_fused` (GLONASS
L3OC pilot + data) each run all n_blocks code periods of C channels in
one launch of a hand-written CUDA kernel (csrc/track_fused.cu,
csrc/track_boc_fused.cu, csrc/track_dual_fused.cu; see the notes there for
what bounds them on an H100). The `*_ref` functions are their plain
PyTorch twins: the same algorithm with the block loop in Python, channels
batched. A wrapper takes its twin only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.

K1 layouts (the reference's, with the chunk kept [N, 2], u32 values in
int64 tensors, and the tap table as int8 with its rows padded):
  chunk     f32 [N, 2]        I/Q samples shared by all channels
  tab       i8  [C, R, bp]    phase-row code tables: fused_code_table's
                              +-1 rows on lanes [0, blkp), zeros up to
                              bp = plane_stride(blkp) (fused_tap_rows)
  pos0      i32 [C]           chunk cursor per channel
  finit     f32 [C, 16]       float state + consts (_F_* lanes)
  cinit     i64 [C]           u32 carrier NCO phase
  carrbase  i64 [C]           u32 base carrier NCO step
Outputs:
  out f32 [n_blocks, C, 16] (O_* lanes), ffin f32 [C, 16], pos i32 [C],
  cphase i64 [C] (u32 values).

K2 takes the same chunk / pos0 / finit (with the _F_*_SUB lanes) / cinit /
carrbase and two tap tables, the E/P/L planes of the reference's
[.., 8, BP] tables as int8 (every tap is +-1), each plane padded with
zeros to bp = plane_stride(blkp) lanes (a multiple of 128):
  ctab      i8  [C, Rc, 3, bp]   per-channel primary-code tap rows
  stab      i8  [Rs, 3, bp]      shared meandr (subcarrier) tap rows
and returns out f32 [n_blocks, C, 24] (OB_* lanes), ffin, pos, cphase.

K3 takes the same chunk / pos0 / finit / cinit / carrbase and one tap
table, the six used planes of the reference's f32 [.., 8, BP] table as
int8, padded as K2's:
  tab       i8  [C, R, 6, bp]    pilot E/P/L, data E/P/L tap rows
and returns out f32 [n_blocks, C, 24] (OD_* lanes), ffin, pos, cphase.

K1 runs each channel on one CTA that prefetches the next block's window
and tap rows into shared memory while it works on the current one
(csrc/track_fused.cu). K2 and K3 run each channel on a thread-block
cluster of N CTAs, each owning S samples of a block (cluster_split;
csrc/cluster_track.cuh). Every kernel takes blocks of up to MAX_BLKP
samples.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gnsstpu_torch.device import U32_MASK, f32, u32_to_i32

# Float-state lanes (finit / ffin), as the reference's _F_*.
(_F_REM, _F_CODE_DELTA, _F_CARR_DELTA, _F_CARR_NCO, _F_OLD_CARR_ERR,
 _F_CODE_NCO, _F_OLD_CODE_ERR, _F_IP_PREV, _F_QP_PREV,
 _F_DOPPLER_BASIS, _F_INV_AID) = range(11)
NF = 16

# Output lanes (tracking.scan.TrackOut field order), as the reference's O_*.
(O_IE, O_QE, O_IP, O_QP, O_IL, O_QL, O_CARR_DOPPLER, O_CODE_FREQ_DELTA,
 O_REM, O_BLKSIZE, O_DLL_DISC, O_DLL_FILT, O_PLL_DISC, O_PLL_FILT) = \
    range(14)
NOUT = 16

# K2: extra float-state lanes for the second (subcarrier) estimator.
_F_REM_SUB, _F_SUB_DELTA, _F_SLL_NCO, _F_OLD_SLL_ERR, _F_INV_AID_SUB = \
    range(11, 16)
# K2 output lanes (accumulator order as ops.boc.BocBlockOut).
(OB_IEP, OB_QEP, OB_IPE, OB_QPE, OB_IPP, OB_QPP, OB_IPL, OB_QPL,
 OB_ILP, OB_QLP, OB_CARR_DOPPLER, OB_CODE_FREQ_DELTA, OB_SUB_FREQ_DELTA,
 OB_REM, OB_REM_SUB, OB_BLKSIZE, OB_DLL_DISC, OB_SLL_DISC,
 OB_PLL_DISC) = range(19)
NOUT_B = 24
#: The ten K2 accumulator lanes, in output order.
OB_ACCS = tuple(range(OB_IEP, OB_QLP + 1))

# K3 output lanes (accumulator order as ops.dualcode.DualBlockOut).
(OD_IE, OD_QE, OD_IP, OD_QP, OD_IL, OD_QL,
 OD_IE2, OD_QE2, OD_IP2, OD_QP2, OD_IL2, OD_QL2,
 OD_CARR_DOPPLER, OD_CODE_FREQ_DELTA, OD_REM, OD_BLKSIZE,
 OD_DLL_DISC, OD_PLL_DISC) = range(18)
NOUT_D = 24
#: The twelve K3 accumulator lanes, in output order.
OD_ACCS = tuple(range(OD_IE, OD_QL2 + 1))

SOURCE = "track_fused.cu"
BOC_SOURCE = "track_boc_fused.cu"
DUAL_SOURCE = "track_dual_fused.cu"
#: Kernel launches since the last reset (plain count; CPU runs of the
#: plain twins are not launches).
LAUNCHES = {"track_chunk_fused": 0, "track_chunk_boc_fused": 0,
            "track_chunk_dual_fused": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


#: Most CTAs in one of K2's / K3's clusters (the portable cluster size).
MAX_CLUSTER = 8
#: Longest block (samples) any of the three kernels takes
#: (csrc/cluster_track.cuh MAX_BLKP).
MAX_BLKP = 32768
#: Phases of K1's stamped instance, in the order of its stamps' columns.
#: Off the chain (beside it, on other warps): the window's warp starting
#: the next block's window copy, and the LO angles. The chain (thread 0's):
#: the wait on this block's copies, products, reduction, loop update, and
#: the closing barrier (with what of the angles outlasts the update).
FUSED_PHASES = ("issue", "angles", "wait", "products", "reduction", "update",
                "barrier")
FUSED_CHAIN = FUSED_PHASES[2:]


def plane_stride(blkp: int) -> int:
    """Lanes of one tap plane (K1's rows, K2's and K3's planes): blkp
    rounded up to 128, so every 16-tap vector of a plane is 16-byte
    aligned."""
    return -(-blkp // 128) * 128


def cluster_split(C: int, blkp: int, n_sms: int) -> tuple:
    """(N, S) for K2 / K3: N CTAs per channel's cluster, as many as the
    card's n_sms SMs give each of the C channels, at most MAX_CLUSTER;
    CTA i owns the block-relative samples [i S, (i + 1) S) of [0, blk),
    S = ceil(blkp / N) rounded up to 16 (one 16-sample vector per thread
    and step)."""
    N = min(max(n_sms // max(C, 1), 1), MAX_CLUSTER)
    S = -(-(-(-blkp // N)) // 16) * 16
    return N, S


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _consts(*, code_length, phases_per_chip, spacing, span_chips,
            base_code_step, fs, coefs):
    """The kernel's f32 constants, rounded from Python doubles exactly
    as the reference rounds its closure constants."""
    k1, k2, k3, c_dll_p, c_dll_i = coefs
    return dict(
        code_length=f32(code_length),
        base_code_step=f32(base_code_step),
        inv_fs=f32(1.0 / fs),
        nco_scale=f32(4294967296.0 / fs),
        ph=f32(float(phases_per_chip)),
        row_off=tuple(f32(off + span_chips)
                      for off in (-spacing, 0.0, spacing)),
        ang_scale=f32(2.0 * np.pi / 4294967296.0),
        inv_pi=f32(1.0 / np.pi),
        inv_2pi=f32(1.0 / (2.0 * np.pi)),
        k1=f32(k1), k2=f32(k2), k3=f32(k3),
        c_dll_p=f32(c_dll_p), c_dll_i=f32(c_dll_i))


def env_err(ie, qe, il, ql):
    """Normalized early-minus-late envelope discriminator
    (|E| - |L|) / max(|E| + |L|, 1e-10), the DLL's and the SLL's."""
    e_env = torch.sqrt(ie * ie + qe * qe)
    l_env = torch.sqrt(il * il + ql * ql)
    return (e_env - l_env) / torch.clamp(e_env + l_env, min=1e-10)


def _factored_lo(ph, cstep, blkp: int, ang_scale: float):
    """The kernels' exact-u32 factored LO for one block, k = 64 a + r:
    cos/sin of the coarse angles (phase + a * 64 * step) and the fine
    angles (r * step), each from the int32 view of the u32 phase,
    combined by the angle-sum products. ph, cstep: int64 [C] u32 values.
    Returns (lo_c, lo_s) f32 [C, blkp]."""
    dev = ph.device
    ia = torch.arange(-(-blkp // 64), dtype=torch.int64, device=dev)
    ir = torch.arange(64, dtype=torch.int64, device=dev)
    ka = (ph[:, None] + ia[None, :] * ((cstep * 64) & U32_MASK)[:, None]
          ) & U32_MASK
    kr = (ir[None, :] * cstep[:, None]) & U32_MASK
    aa = u32_to_i32(ka).to(torch.float32) * ang_scale
    ar = u32_to_i32(kr).to(torch.float32) * ang_scale
    ca, sa = torch.cos(aa), torch.sin(aa)
    cr, sr = torch.cos(ar), torch.sin(ar)
    C = ph.shape[0]
    lo_c = (ca[:, :, None] * cr[:, None, :]
            - sa[:, :, None] * sr[:, None, :]).reshape(C, -1)[:, :blkp]
    lo_s = (sa[:, :, None] * cr[:, None, :]
            + ca[:, :, None] * sr[:, None, :]).reshape(C, -1)[:, :blkp]
    return lo_c, lo_s


def track_chunk_fused_ref(chunk, tab, pos0, finit, cinit, carrbase, *,
                          n_blocks: int, blkp: int, code_length: int,
                          phases_per_chip: int, spacing: float,
                          span_chips: float, base_code_step: float,
                          fs: float, coefs, fll_disc: str = "atan2"):
    """Plain PyTorch version of K1 (same algorithm, block loop in Python)."""
    flip_fll = _fll_atan(fll_disc)
    k = _consts(code_length=code_length, phases_per_chip=phases_per_chip,
                spacing=spacing, span_chips=span_chips,
                base_code_step=base_code_step, fs=fs, coefs=coefs)
    dev = chunk.device
    C, R = tab.shape[0], tab.shape[1]
    n = chunk.shape[0]
    st = finit.clone()
    ph = cinit.clone()
    pos = pos0.to(torch.int64)
    kk = torch.arange(blkp, device=dev)
    ch = torch.arange(C, device=dev)
    outs = []
    for _ in range(n_blocks):
        rem = st[:, _F_REM]
        step = k["base_code_step"] + st[:, _F_CODE_DELTA] * k["inv_fs"]
        blkf = torch.ceil((k["code_length"] - rem) / step)
        blk = torch.clamp(blkf.to(torch.int64), 1, blkp)
        cstep = (carrbase + torch.round(st[:, _F_CARR_DELTA]
                                        * k["nco_scale"]).to(torch.int64)
                 ) & U32_MASK
        rows = [torch.clamp(torch.round((rem + off) * k["ph"]
                                        ).to(torch.int64), 0, R - 1)
                for off in k["row_off"]]

        idx = torch.clamp(pos[:, None] + kk[None, :], 0, n - 1)
        win = chunk[idx]                                   # [C, blkp, 2]
        xi, xq = win[..., 0], win[..., 1]
        mask = (kk[None, :] < blk[:, None]).to(torch.float32)

        lo_c, lo_s = _factored_lo(ph, cstep, blkp, k["ang_scale"])
        bb_i = (xi * lo_c + xq * lo_s) * mask
        bb_q = (xq * lo_c - xi * lo_s) * mask
        # Taps widened to f32 (int8 rows padded past blkp).
        e_rows, p_rows, l_rows = (tab[ch, r, :blkp].to(torch.float32)
                                  for r in rows)
        ie = (e_rows * bb_i).sum(1)
        qe = (e_rows * bb_q).sum(1)
        ip = (p_rows * bb_i).sum(1)
        qp = (p_rows * bb_q).sum(1)
        il = (l_rows * bb_i).sum(1)
        ql = (l_rows * bb_q).sum(1)

        ip_prev, qp_prev = st[:, _F_IP_PREV], st[:, _F_QP_PREV]
        cross = ip * qp_prev - ip_prev * qp
        dot = ip * ip_prev + qp * qp_prev
        if flip_fll:
            cross = cross * torch.sign(dot)
        freq_err = torch.atan2(cross, torch.abs(dot)) * k["inv_pi"]
        denom = torch.where(torch.abs(ip) < 1e-10,
                            torch.full_like(ip, 1e-10), ip)
        carr_err = torch.atan(qp / denom) * k["inv_2pi"]
        carr_nco = (st[:, _F_CARR_NCO] + k["k1"] * carr_err
                    - k["k2"] * st[:, _F_OLD_CARR_ERR] - k["k3"] * freq_err)
        carr_delta = st[:, _F_DOPPLER_BASIS] + carr_nco
        code_err = env_err(ie, qe, il, ql)
        code_nco = (st[:, _F_CODE_NCO]
                    + k["c_dll_p"] * (code_err - st[:, _F_OLD_CODE_ERR])
                    + code_err * k["c_dll_i"])
        code_delta = -code_nco + carr_delta * st[:, _F_INV_AID]
        new_rem = rem + blk.to(torch.float32) * step - k["code_length"]

        zero = torch.zeros_like(ie)
        outs.append(torch.stack(
            [ie, qe, ip, qp, il, ql, carr_delta, code_delta, new_rem,
             blk.to(torch.float32), code_err, code_nco, carr_err, carr_nco,
             zero, zero], dim=1))
        st = st.clone()
        for lane, v in ((_F_REM, new_rem), (_F_CODE_DELTA, code_delta),
                        (_F_CARR_DELTA, carr_delta), (_F_CARR_NCO, carr_nco),
                        (_F_OLD_CARR_ERR, carr_err), (_F_CODE_NCO, code_nco),
                        (_F_OLD_CODE_ERR, code_err), (_F_IP_PREV, ip),
                        (_F_QP_PREV, qp)):
            st[:, lane] = v
        ph = (ph + blk * cstep) & U32_MASK
        pos = pos + blk
    out = (torch.stack(outs) if outs
           else torch.zeros((0, C, NOUT), dtype=torch.float32, device=dev))
    return out, st, pos.to(torch.int32), ph


def _lib():
    from gnsstpu_torch.ops import cuda_build

    built = cuda_build.load(SOURCE)
    fn = built.lib.track_chunk_fused_cuda
    if not fn.argtypes:
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([p, ctypes.c_longlong] + [p] * 10 + [i] * 5
                       + [fl] * 15 + [i, p])
        fn.restype = ctypes.c_int
        info = built.lib.track_fused_info
        info.argtypes = [i, p]
        info.restype = ctypes.c_int
        err = built.lib.track_fused_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built


def _check(name, t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _fll_atan(fll_disc: str) -> bool:
    """K1's FLL discriminator: 'atan2' (four-quadrant, the reference
    kernel's) or 'atan' (atan2(cross * sign(dot), |dot|), immune to a
    symbol flip between consecutive blocks, as TrackConfig.fll_disc)."""
    if fll_disc not in ("atan2", "atan"):
        raise ValueError(f"fll_disc {fll_disc!r} not in ('atan2', 'atan')")
    return fll_disc == "atan"


def _check_blkp(blkp: int) -> None:
    if not 1 <= blkp <= MAX_BLKP:
        raise ValueError(f"blkp {blkp} outside [1, MAX_BLKP = {MAX_BLKP}]: "
                         f"longer blocks than the kernels take")


def _check_fused(chunk, tab, pos0, finit, cinit, carrbase, blkp: int,
                 n_blocks: int) -> None:
    """K1's argument checks, the same on every device."""
    _check_blkp(blkp)
    dev = chunk.device
    C, R = tab.shape[0], tab.shape[1]
    _check("chunk", chunk, torch.float32, (chunk.shape[0], 2), dev)
    _check("tab", tab, torch.int8, (C, R, plane_stride(blkp)), dev)
    _check("pos0", pos0, torch.int32, (C,), dev)
    _check("finit", finit, torch.float32, (C, NF), dev)
    _check("cinit", cinit, torch.int64, (C,), dev)
    _check("carrbase", carrbase, torch.int64, (C,), dev)
    if n_blocks < 0:
        raise ValueError("n_blocks must be >= 0")


def _launch_fused(chunk, tab, pos0, finit, cinit, carrbase, stamps, *,
                  n_blocks: int, blkp: int, code_length: int,
                  phases_per_chip: int, spacing: float, span_chips: float,
                  base_code_step: float, fs: float, coefs,
                  fll_disc: str = "atan2"):
    """One launch of K1 (its stamped instance when stamps is not None)
    on CUDA tensors already checked; returns (out, ffin, pos, cphase)."""
    dev = chunk.device
    if chunk.data_ptr() % 8:
        raise ValueError("chunk must be 8-byte aligned")
    _check_aligned16("tab", tab)
    C, R = tab.shape[0], tab.shape[1]
    out = torch.empty((n_blocks, C, NOUT), dtype=torch.float32, device=dev)
    ffin = torch.empty((C, NF), dtype=torch.float32, device=dev)
    pos = torch.empty((C,), dtype=torch.int32, device=dev)
    cph = torch.empty((C,), dtype=torch.int64, device=dev)
    k = _consts(code_length=code_length, phases_per_chip=phases_per_chip,
                spacing=spacing, span_chips=span_chips,
                base_code_step=base_code_step, fs=fs, coefs=coefs)
    built = _lib()
    # The C entry sets the kernel's attributes on the current device and
    # launches on the stream given: both must be the tensors' card.
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = built.lib.track_chunk_fused_cuda(
            chunk.data_ptr(), chunk.shape[0], tab.data_ptr(),
            pos0.data_ptr(), finit.data_ptr(), cinit.data_ptr(),
            carrbase.data_ptr(), out.data_ptr(), ffin.data_ptr(),
            pos.data_ptr(), cph.data_ptr(),
            None if stamps is None else stamps.data_ptr(),
            C, n_blocks, R, blkp, code_length,
            k["base_code_step"], k["inv_fs"], k["nco_scale"], k["ph"],
            *k["row_off"], k["ang_scale"], k["inv_pi"], k["inv_2pi"],
            k["k1"], k["k2"], k["k3"], k["c_dll_p"], k["c_dll_i"],
            int(_fll_atan(fll_disc)), stream)
    if rc != 0:
        msg = built.lib.track_fused_error_string(rc).decode()
        raise RuntimeError(f"track_chunk_fused launch failed: {msg} ({rc})")
    return out, ffin, pos, cph


def track_chunk_fused(chunk, tab, pos0, finit, cinit, carrbase, *,
                      n_blocks: int, blkp: int, code_length: int,
                      phases_per_chip: int, spacing: float,
                      span_chips: float, base_code_step: float, fs: float,
                      coefs, fll_disc: str = "atan2"):
    """Run K1. coefs = (k1, k2, k3, c_dll_p, c_dll_i); fll_disc 'atan2'
    or 'atan' (_fll_atan).

    Dtypes and shapes are checked on every device (blkp <= MAX_BLKP, tab
    int8 [C, R, plane_stride(blkp)]). CPU tensors then run the plain
    twin; CUDA tensors launch the kernel (on torch.cuda.current_stream())
    or raise.
    """
    kw = dict(n_blocks=n_blocks, blkp=blkp, code_length=code_length,
              phases_per_chip=phases_per_chip, spacing=spacing,
              span_chips=span_chips, base_code_step=base_code_step, fs=fs,
              coefs=coefs, fll_disc=fll_disc)
    _check_fused(chunk, tab, pos0, finit, cinit, carrbase, blkp, n_blocks)
    _fll_atan(fll_disc)
    dev = chunk.device
    if dev.type == "cpu":
        return track_chunk_fused_ref(chunk, tab, pos0, finit, cinit,
                                     carrbase, **kw)
    if dev.type != "cuda":
        raise ValueError(f"track_chunk_fused: unsupported device {dev}")
    res = _launch_fused(chunk, tab, pos0, finit, cinit, carrbase, None, **kw)
    LAUNCHES["track_chunk_fused"] += 1
    return res


def track_chunk_fused_stamped(chunk, tab, pos0, finit, cinit, carrbase,
                              **kw):
    """K1's stamped instance on CUDA tensors, for measurement: the same
    outputs as track_chunk_fused plus stamps int64 [C, len(FUSED_PHASES)],
    each channel's SM cycles per phase summed over its blocks (clock64()
    on the thread each phase runs on; FUSED_CHAIN are thread 0's). Not a
    launch of the main path, so not counted in LAUNCHES."""
    _check_fused(chunk, tab, pos0, finit, cinit, carrbase, kw["blkp"],
                 kw["n_blocks"])
    if chunk.device.type != "cuda":
        raise ValueError("track_chunk_fused_stamped needs CUDA tensors")
    stamps = torch.zeros((tab.shape[0], len(FUSED_PHASES)),
                         dtype=torch.int64, device=chunk.device)
    res = _launch_fused(chunk, tab, pos0, finit, cinit, carrbase, stamps,
                        **kw)
    return (*res, stamps)


def fused_info(blkp: int) -> dict:
    """What K1's main instance uses at this blkp: threads per CTA,
    registers, static / dynamic shared and local bytes per CTA, samples
    per prefetch buffer (W; past it a block is read from global memory)
    and cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    _check_blkp(blkp)
    lib = _lib().lib
    info = (ctypes.c_int * 7)()
    rc = lib.track_fused_info(blkp, ctypes.addressof(info))
    if rc != 0:
        msg = lib.track_fused_error_string(rc).decode()
        raise RuntimeError(f"track_chunk_fused info failed: {msg} ({rc})")
    return dict(blkp=blkp, threads=info[3], registers=info[0],
                static_smem=info[1], dynamic_smem=info[4],
                local_bytes=info[2], ctas_per_sm=info[5],
                buffered_samples=info[6])


# ---------------------------------------------------------------------------
# K2: the BOC double-estimator fused kernel (Galileo E1B).
# ---------------------------------------------------------------------------

#: K2's f32 constants, in the order csrc/track_boc_fused.cu reads them.
BOC_CONSTS = ("code_length", "sub_length", "base_code_step",
              "base_sub_step", "inv_fs", "nco_scale", "ph_code", "ph_sub",
              "span_code", "span_sub", "ang_scale", "inv_pi", "inv_2pi",
              "k1", "k2", "k3", "c_dll_p", "c_dll_i", "c_sll_p", "c_sll_i")


def _boc_consts(*, code_length, sub_length, ph_code, ph_sub, span_code,
                span_sub, base_code_step, base_sub_step, fs, coefs):
    """K2's f32 constants, rounded from Python doubles exactly as the
    reference rounds its closure constants."""
    k1, k2, k3, c_dll_p, c_dll_i, c_sll_p, c_sll_i = coefs
    return dict(
        code_length=f32(code_length), sub_length=f32(sub_length),
        base_code_step=f32(base_code_step),
        base_sub_step=f32(base_sub_step),
        inv_fs=f32(1.0 / fs), nco_scale=f32(4294967296.0 / fs),
        ph_code=f32(float(ph_code)), ph_sub=f32(float(ph_sub)),
        span_code=f32(span_code), span_sub=f32(span_sub),
        ang_scale=f32(2.0 * np.pi / 4294967296.0),
        inv_pi=f32(1.0 / np.pi), inv_2pi=f32(1.0 / (2.0 * np.pi)),
        k1=f32(k1), k2=f32(k2), k3=f32(k3),
        c_dll_p=f32(c_dll_p), c_dll_i=f32(c_dll_i),
        c_sll_p=f32(c_sll_p), c_sll_i=f32(c_sll_i))


def track_chunk_boc_fused_ref(chunk, ctab, stab, pos0, finit, cinit,
                              carrbase, *, n_blocks: int, blkp: int,
                              code_length: int, sub_length: int,
                              ph_code: int, ph_sub: int, span_code: float,
                              span_sub: float, base_code_step: float,
                              base_sub_step: float, fs: float, coefs):
    """Plain PyTorch version of K2 (same algorithm, block loop in Python).
    coefs = (k1, k2, k3, c_dll_p, c_dll_i, c_sll_p, c_sll_i)."""
    k = _boc_consts(code_length=code_length, sub_length=sub_length,
                    ph_code=ph_code, ph_sub=ph_sub, span_code=span_code,
                    span_sub=span_sub, base_code_step=base_code_step,
                    base_sub_step=base_sub_step, fs=fs, coefs=coefs)
    dev = chunk.device
    C, Rc, Rs = ctab.shape[0], ctab.shape[1], stab.shape[0]
    n = chunk.shape[0]
    st = finit.clone()
    ph = cinit.clone()
    pos = pos0.to(torch.int64)
    kk = torch.arange(blkp, device=dev)
    ch = torch.arange(C, device=dev)
    outs = []
    for _ in range(n_blocks):
        rem, rem_s = st[:, _F_REM], st[:, _F_REM_SUB]
        step_c = k["base_code_step"] + st[:, _F_CODE_DELTA] * k["inv_fs"]
        step_s = k["base_sub_step"] + st[:, _F_SUB_DELTA] * k["inv_fs"]
        blkf = torch.ceil((k["code_length"] - rem) / step_c)
        blk = torch.clamp(blkf.to(torch.int64), 1, blkp)
        cstep = (carrbase + torch.round(st[:, _F_CARR_DELTA]
                                        * k["nco_scale"]).to(torch.int64)
                 ) & U32_MASK
        row_c = torch.clamp(torch.round((rem + k["span_code"])
                                        * k["ph_code"]).to(torch.int64),
                            0, Rc - 1)
        row_s = torch.clamp(torch.round((rem_s + k["span_sub"])
                                        * k["ph_sub"]).to(torch.int64),
                            0, Rs - 1)

        # Samples outside the chunk read as zero, as in the kernel.
        idx = pos[:, None] + kk[None, :]
        inside = ((idx >= 0) & (idx < n)).to(torch.float32)
        win = chunk[torch.clamp(idx, 0, n - 1)]            # [C, blkp, 2]
        xi, xq = win[..., 0] * inside, win[..., 1] * inside
        mask = (kk[None, :] < blk[:, None]).to(torch.float32)
        lo_c, lo_s = _factored_lo(ph, cstep, blkp, k["ang_scale"])
        bb_i = (xi * lo_c + xq * lo_s) * mask
        bb_q = (xq * lo_c - xi * lo_s) * mask
        # Taps widened to f32 (int8 tables; f32 ones pass through).
        code_e, code_p, code_l = ctab[ch, row_c, :, :blkp].to(
            torch.float32).unbind(1)                       # [C, blkp]
        sub_e, sub_p, sub_l = stab[row_s, :, :blkp].to(
            torch.float32).unbind(1)
        accs = []
        for t in (sub_e * code_p, sub_p * code_e, sub_p * code_p,
                  sub_p * code_l, sub_l * code_p):
            accs += [(t * bb_i).sum(1), (t * bb_q).sum(1)]
        iep, qep, ipe, qpe, ipp, qpp, ipl, qpl, ilp, qlp = accs

        ip_prev, qp_prev = st[:, _F_IP_PREV], st[:, _F_QP_PREV]
        cross = ipp * qp_prev - ip_prev * qpp
        dot = ipp * ip_prev + qpp * qp_prev
        safe = torch.where(torch.abs(dot) < 1e-30,
                           torch.where(dot < 0, torch.full_like(dot, -1e-30),
                                       torch.full_like(dot, 1e-30)), dot)
        freq_err = torch.atan(cross / safe) * k["inv_pi"]
        denom = torch.where(torch.abs(ipp) < 1e-10,
                            torch.full_like(ipp, 1e-10), ipp)
        carr_err = torch.atan(qpp / denom) * k["inv_2pi"]
        carr_nco = (st[:, _F_CARR_NCO] + k["k1"] * carr_err
                    - k["k2"] * st[:, _F_OLD_CARR_ERR] - k["k3"] * freq_err)
        carr_delta = st[:, _F_DOPPLER_BASIS] + carr_nco
        code_err = env_err(ipe, qpe, ipl, qpl)
        code_nco = (st[:, _F_CODE_NCO]
                    + k["c_dll_p"] * (code_err - st[:, _F_OLD_CODE_ERR])
                    + code_err * k["c_dll_i"])
        code_delta = -code_nco + carr_delta * st[:, _F_INV_AID]
        sll_err = env_err(iep, qep, ilp, qlp)
        sll_nco = (st[:, _F_SLL_NCO]
                   + k["c_sll_p"] * (sll_err - st[:, _F_OLD_SLL_ERR])
                   + sll_err * k["c_sll_i"])
        sub_delta = -sll_nco + carr_delta * st[:, _F_INV_AID_SUB]
        bsf = blk.to(torch.float32)
        new_rem = rem + bsf * step_c - k["code_length"]
        new_rem_s = rem_s + bsf * step_s - k["sub_length"]

        zero = torch.zeros_like(ipp)
        outs.append(torch.stack(
            accs + [carr_delta, code_delta, sub_delta, new_rem, new_rem_s,
                    bsf, code_err, sll_err, carr_err]
            + [zero] * (NOUT_B - 19), dim=1))
        st = st.clone()
        for lane, v in ((_F_REM, new_rem), (_F_REM_SUB, new_rem_s),
                        (_F_CODE_DELTA, code_delta),
                        (_F_SUB_DELTA, sub_delta),
                        (_F_CARR_DELTA, carr_delta), (_F_CARR_NCO, carr_nco),
                        (_F_OLD_CARR_ERR, carr_err), (_F_CODE_NCO, code_nco),
                        (_F_OLD_CODE_ERR, code_err), (_F_SLL_NCO, sll_nco),
                        (_F_OLD_SLL_ERR, sll_err), (_F_IP_PREV, ipp),
                        (_F_QP_PREV, qpp)):
            st[:, lane] = v
        ph = (ph + blk * cstep) & U32_MASK
        pos = pos + blk
    out = (torch.stack(outs) if outs
           else torch.zeros((0, C, NOUT_B), dtype=torch.float32, device=dev))
    return out, st, pos.to(torch.int32), ph


def _boc_lib():
    from gnsstpu_torch.ops import cuda_build

    built = cuda_build.load(BOC_SOURCE)
    fn = built.lib.track_chunk_boc_fused_cuda
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p, ctypes.c_longlong] + [p] * 10 + [i] * 6
                       + [p, i, p])
        fn.restype = ctypes.c_int
        _bind_info_and_errors(built.lib, "track_boc_fused")
    return built


def _bind_info_and_errors(lib, stem: str) -> None:
    info = getattr(lib, f"{stem}_cluster_info")
    info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    info.restype = ctypes.c_int
    err = getattr(lib, f"{stem}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p


def cluster_info(kernel: str, C: int, blkp: int, device) -> dict:
    """K2's or K3's launch at C channels on this card (cluster_split) and
    what its compiled kernel uses: registers, static / dynamic shared and
    local bytes per CTA, and cudaOccupancyMaxActiveClusters (how many of
    its clusters the card holds at once)."""
    load, stem = {"track_chunk_boc_fused": (_boc_lib, "track_boc_fused"),
                  "track_chunk_dual_fused": (_dual_lib, "track_dual_fused")
                  }[kernel]
    lib = load().lib
    N, S = cluster_split(C, blkp, _sm_count(device))
    info = (ctypes.c_int * 6)()
    rc = getattr(lib, f"{stem}_cluster_info")(C, N, ctypes.addressof(info))
    if rc != 0:
        msg = getattr(lib, f"{stem}_error_string")(rc).decode()
        raise RuntimeError(f"{kernel} cluster info failed: {msg} ({rc})")
    return dict(C=C, N=N, S=S, threads=info[3], registers=info[0],
                static_smem=info[1], dynamic_smem=info[4],
                local_bytes=info[2], max_active_clusters=info[5])


def _check_aligned16(name, t):
    """K2 and K3 read taps as 16-byte vectors."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def build_all() -> dict:
    """Build (or load) every kernel library of the port, one nvcc per
    source, all started together. Returns {kernel name:
    cuda_build.BuiltLibrary}."""
    from gnsstpu_torch.ops import cuda_build

    cuda_build.load_many([SOURCE, BOC_SOURCE, DUAL_SOURCE])
    return {"track_chunk_fused": _lib(),
            "track_chunk_boc_fused": _boc_lib(),
            "track_chunk_dual_fused": _dual_lib()}


def track_chunk_boc_fused(chunk, ctab, stab, pos0, finit, cinit, carrbase,
                          *, n_blocks: int, blkp: int, code_length: int,
                          sub_length: int, ph_code: int, ph_sub: int,
                          span_code: float, span_sub: float,
                          base_code_step: float, base_sub_step: float,
                          fs: float, coefs):
    """Run K2. coefs = (k1, k2, k3, c_dll_p, c_dll_i, c_sll_p, c_sll_i).

    CPU tensors run the plain twin; CUDA tensors launch the kernel (on
    torch.cuda.current_stream()) or raise.
    """
    kw = dict(n_blocks=n_blocks, blkp=blkp, code_length=code_length,
              sub_length=sub_length, ph_code=ph_code, ph_sub=ph_sub,
              span_code=span_code, span_sub=span_sub,
              base_code_step=base_code_step, base_sub_step=base_sub_step,
              fs=fs, coefs=coefs)
    dev = chunk.device
    if dev.type == "cpu":
        return track_chunk_boc_fused_ref(chunk, ctab, stab, pos0, finit,
                                         cinit, carrbase, **kw)
    if dev.type != "cuda":
        raise ValueError(f"track_chunk_boc_fused: unsupported device {dev}")
    C, Rc, Rs = ctab.shape[0], ctab.shape[1], stab.shape[0]
    bp = plane_stride(blkp)
    _check("chunk", chunk, torch.float32, (chunk.shape[0], 2), dev)
    _check("ctab", ctab, torch.int8, (C, Rc, 3, bp), dev)
    _check("stab", stab, torch.int8, (Rs, 3, bp), dev)
    _check_aligned16("ctab", ctab)
    _check_aligned16("stab", stab)
    _check("pos0", pos0, torch.int32, (C,), dev)
    _check("finit", finit, torch.float32, (C, NF), dev)
    _check("cinit", cinit, torch.int64, (C,), dev)
    _check("carrbase", carrbase, torch.int64, (C,), dev)
    if n_blocks < 0:
        raise ValueError("n_blocks must be >= 0")
    out = torch.empty((n_blocks, C, NOUT_B), dtype=torch.float32,
                      device=dev)
    ffin = torch.empty((C, NF), dtype=torch.float32, device=dev)
    pos = torch.empty((C,), dtype=torch.int32, device=dev)
    cph = torch.empty((C,), dtype=torch.int64, device=dev)
    k = _boc_consts(code_length=code_length, sub_length=sub_length,
                    ph_code=ph_code, ph_sub=ph_sub, span_code=span_code,
                    span_sub=span_sub, base_code_step=base_code_step,
                    base_sub_step=base_sub_step, fs=fs, coefs=coefs)
    consts = (ctypes.c_float * len(BOC_CONSTS))(
        *(k[name] for name in BOC_CONSTS))
    N, _ = cluster_split(C, blkp, _sm_count(dev))
    built = _boc_lib()
    with torch.cuda.device(dev):         # as in _launch_fused
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = built.lib.track_chunk_boc_fused_cuda(
            chunk.data_ptr(), chunk.shape[0], ctab.data_ptr(),
            stab.data_ptr(), pos0.data_ptr(), finit.data_ptr(),
            cinit.data_ptr(), carrbase.data_ptr(), out.data_ptr(),
            ffin.data_ptr(), pos.data_ptr(), cph.data_ptr(), C, n_blocks,
            Rc, Rs, blkp, N, ctypes.cast(consts, ctypes.c_void_p),
            len(BOC_CONSTS), stream)
    if rc != 0:
        msg = built.lib.track_boc_fused_error_string(rc).decode()
        raise RuntimeError(
            f"track_chunk_boc_fused launch failed: {msg} ({rc})")
    LAUNCHES["track_chunk_boc_fused"] += 1
    return out, ffin, pos, cph


# ---------------------------------------------------------------------------
# K3: the dual-code (pilot + data) fused kernel (GLONASS L3OC).
# ---------------------------------------------------------------------------

#: K3's f32 constants, in the order csrc/track_dual_fused.cu reads them.
DUAL_CONSTS = ("code_length", "base_code_step", "inv_fs", "nco_scale", "ph",
               "span", "ang_scale", "inv_pi", "inv_2pi", "k1", "k2", "k3",
               "c_dll_p", "c_dll_i")


def _dual_consts(*, code_length, phases_per_chip, span_chips,
                 base_code_step, fs, coefs):
    """K3's f32 constants, rounded from Python doubles exactly as the
    reference rounds its closure constants."""
    k1, k2, k3, c_dll_p, c_dll_i = coefs
    return dict(
        code_length=f32(code_length), base_code_step=f32(base_code_step),
        inv_fs=f32(1.0 / fs), nco_scale=f32(4294967296.0 / fs),
        ph=f32(float(phases_per_chip)), span=f32(span_chips),
        ang_scale=f32(2.0 * np.pi / 4294967296.0),
        inv_pi=f32(1.0 / np.pi), inv_2pi=f32(1.0 / (2.0 * np.pi)),
        k1=f32(k1), k2=f32(k2), k3=f32(k3),
        c_dll_p=f32(c_dll_p), c_dll_i=f32(c_dll_i))


def track_chunk_dual_fused_ref(chunk, tab, pos0, finit, cinit, carrbase, *,
                               n_blocks: int, blkp: int, code_length: int,
                               phases_per_chip: int, span_chips: float,
                               base_code_step: float, fs: float, coefs):
    """Plain PyTorch version of K3 (same algorithm, block loop in Python).
    coefs = (k1, k2, k3, c_dll_p, c_dll_i)."""
    k = _dual_consts(code_length=code_length,
                     phases_per_chip=phases_per_chip, span_chips=span_chips,
                     base_code_step=base_code_step, fs=fs, coefs=coefs)
    dev = chunk.device
    C, R = tab.shape[0], tab.shape[1]
    n = chunk.shape[0]
    st = finit.clone()
    ph = cinit.clone()
    pos = pos0.to(torch.int64)
    kk = torch.arange(blkp, device=dev)
    ch = torch.arange(C, device=dev)
    outs = []
    for _ in range(n_blocks):
        rem = st[:, _F_REM]
        step = k["base_code_step"] + st[:, _F_CODE_DELTA] * k["inv_fs"]
        blkf = torch.ceil((k["code_length"] - rem) / step)
        blk = torch.clamp(blkf.to(torch.int64), 1, blkp)
        cstep = (carrbase + torch.round(st[:, _F_CARR_DELTA]
                                        * k["nco_scale"]).to(torch.int64)
                 ) & U32_MASK
        # One row per block; the E/L spacing is baked into the planes.
        row = torch.clamp(torch.round((rem + k["span"]) * k["ph"]
                                      ).to(torch.int64), 0, R - 1)

        # Samples outside the chunk read as zero, as in the kernel.
        idx = pos[:, None] + kk[None, :]
        inside = ((idx >= 0) & (idx < n)).to(torch.float32)
        win = chunk[torch.clamp(idx, 0, n - 1)]            # [C, blkp, 2]
        xi, xq = win[..., 0] * inside, win[..., 1] * inside
        mask = (kk[None, :] < blk[:, None]).to(torch.float32)
        lo_c, lo_s = _factored_lo(ph, cstep, blkp, k["ang_scale"])
        bb_i = (xi * lo_c + xq * lo_s) * mask
        bb_q = (xq * lo_c - xi * lo_s) * mask
        taps = tab[ch, row, :, :blkp].to(torch.float32)    # [C, 6, blkp]
        accs = []
        for j in range(6):
            accs += [(taps[:, j] * bb_i).sum(1), (taps[:, j] * bb_q).sum(1)]
        ie, qe, ip, qp, il, ql = accs[:6]

        ip_prev, qp_prev = st[:, _F_IP_PREV], st[:, _F_QP_PREV]
        cross = ip * qp_prev - ip_prev * qp
        dot = ip * ip_prev + qp * qp_prev
        safe = torch.where(torch.abs(dot) < 1e-30,
                           torch.where(dot < 0, torch.full_like(dot, -1e-30),
                                       torch.full_like(dot, 1e-30)), dot)
        freq_err = torch.atan(cross / safe) * k["inv_pi"]
        denom = torch.where(torch.abs(ip) < 1e-10,
                            torch.full_like(ip, 1e-10), ip)
        carr_err = torch.atan(qp / denom) * k["inv_2pi"]
        carr_nco = (st[:, _F_CARR_NCO] + k["k1"] * carr_err
                    - k["k2"] * st[:, _F_OLD_CARR_ERR] - k["k3"] * freq_err)
        carr_delta = st[:, _F_DOPPLER_BASIS] + carr_nco
        code_err = env_err(ie, qe, il, ql)
        code_nco = (st[:, _F_CODE_NCO]
                    + k["c_dll_p"] * (code_err - st[:, _F_OLD_CODE_ERR])
                    + code_err * k["c_dll_i"])
        code_delta = -code_nco + carr_delta * st[:, _F_INV_AID]
        bsf = blk.to(torch.float32)
        new_rem = rem + bsf * step - k["code_length"]

        zero = torch.zeros_like(ip)
        outs.append(torch.stack(
            accs + [carr_delta, code_delta, new_rem, bsf, code_err,
                    carr_err] + [zero] * (NOUT_D - 18), dim=1))
        st = st.clone()
        for lane, v in ((_F_REM, new_rem), (_F_CODE_DELTA, code_delta),
                        (_F_CARR_DELTA, carr_delta), (_F_CARR_NCO, carr_nco),
                        (_F_OLD_CARR_ERR, carr_err), (_F_CODE_NCO, code_nco),
                        (_F_OLD_CODE_ERR, code_err), (_F_IP_PREV, ip),
                        (_F_QP_PREV, qp)):
            st[:, lane] = v
        ph = (ph + blk * cstep) & U32_MASK
        pos = pos + blk
    out = (torch.stack(outs) if outs
           else torch.zeros((0, C, NOUT_D), dtype=torch.float32, device=dev))
    return out, st, pos.to(torch.int32), ph


def _dual_lib():
    from gnsstpu_torch.ops import cuda_build

    built = cuda_build.load(DUAL_SOURCE)
    fn = built.lib.track_chunk_dual_fused_cuda
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p, ctypes.c_longlong] + [p] * 9 + [i] * 5
                       + [p, i, p])
        fn.restype = ctypes.c_int
        _bind_info_and_errors(built.lib, "track_dual_fused")
    return built


def track_chunk_dual_fused(chunk, tab, pos0, finit, cinit, carrbase, *,
                           n_blocks: int, blkp: int, code_length: int,
                           phases_per_chip: int, span_chips: float,
                           base_code_step: float, fs: float, coefs):
    """Run K3. coefs = (k1, k2, k3, c_dll_p, c_dll_i).

    Dtypes and shapes are checked on every device. CPU tensors then run
    the plain twin; CUDA tensors launch the kernel (on
    torch.cuda.current_stream()) or raise.
    """
    kw = dict(n_blocks=n_blocks, blkp=blkp, code_length=code_length,
              phases_per_chip=phases_per_chip, span_chips=span_chips,
              base_code_step=base_code_step, fs=fs, coefs=coefs)
    dev = chunk.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"track_chunk_dual_fused: unsupported device {dev}")
    C, R = tab.shape[0], tab.shape[1]
    bp = plane_stride(blkp)
    _check("chunk", chunk, torch.float32, (chunk.shape[0], 2), dev)
    _check("tab", tab, torch.int8, (C, R, 6, bp), dev)
    _check("pos0", pos0, torch.int32, (C,), dev)
    _check("finit", finit, torch.float32, (C, NF), dev)
    _check("cinit", cinit, torch.int64, (C,), dev)
    _check("carrbase", carrbase, torch.int64, (C,), dev)
    if n_blocks < 0:
        raise ValueError("n_blocks must be >= 0")
    if dev.type == "cpu":
        return track_chunk_dual_fused_ref(chunk, tab, pos0, finit, cinit,
                                          carrbase, **kw)
    out = torch.empty((n_blocks, C, NOUT_D), dtype=torch.float32,
                      device=dev)
    ffin = torch.empty((C, NF), dtype=torch.float32, device=dev)
    pos = torch.empty((C,), dtype=torch.int32, device=dev)
    cph = torch.empty((C,), dtype=torch.int64, device=dev)
    k = _dual_consts(code_length=code_length,
                     phases_per_chip=phases_per_chip, span_chips=span_chips,
                     base_code_step=base_code_step, fs=fs, coefs=coefs)
    consts = (ctypes.c_float * len(DUAL_CONSTS))(
        *(k[name] for name in DUAL_CONSTS))
    _check_aligned16("tab", tab)
    N, _ = cluster_split(C, blkp, _sm_count(dev))
    built = _dual_lib()
    with torch.cuda.device(dev):         # as in _launch_fused
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = built.lib.track_chunk_dual_fused_cuda(
            chunk.data_ptr(), chunk.shape[0], tab.data_ptr(),
            pos0.data_ptr(), finit.data_ptr(), cinit.data_ptr(),
            carrbase.data_ptr(), out.data_ptr(), ffin.data_ptr(),
            pos.data_ptr(), cph.data_ptr(), C, n_blocks, R, blkp, N,
            ctypes.cast(consts, ctypes.c_void_p), len(DUAL_CONSTS),
            stream)
    if rc != 0:
        msg = built.lib.track_dual_fused_error_string(rc).decode()
        raise RuntimeError(
            f"track_chunk_dual_fused launch failed: {msg} ({rc})")
    LAUNCHES["track_chunk_dual_fused"] += 1
    return out, ffin, pos, cph
