"""K1: the fused single-code tracking kernel (port of
gnsstpu/ops/track_kernel.py::track_chunk_fused).

`track_chunk_fused` runs all n_blocks code periods of C channels in one
launch of the hand-written CUDA kernel csrc/track_fused.cu (see the note
there for what bounds it on an H100). `track_chunk_fused_ref` is its plain
PyTorch twin: the same algorithm with the block loop in Python, channels
batched. The wrapper takes the twin only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.

Layouts (the reference's, with the chunk kept [N, 2] and u32 values in
int64 tensors):
  chunk     f32 [N, 2]        I/Q samples shared by all channels
  tab       f32 [C, R, blkp]  phase-row code tables (fused_code_table)
  pos0      i32 [C]           chunk cursor per channel
  finit     f32 [C, 16]       float state + consts (_F_* lanes)
  cinit     i64 [C]           u32 carrier NCO phase
  carrbase  i64 [C]           u32 base carrier NCO step
Outputs:
  out f32 [n_blocks, C, 16] (O_* lanes), ffin f32 [C, 16], pos i32 [C],
  cphase i64 [C] (u32 values).
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

SOURCE = "track_fused.cu"
#: Kernel launches since the last reset (plain count; CPU runs of the
#: plain twin are not launches).
LAUNCHES = {"track_chunk_fused": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def track_chunk_fused_ref(chunk, tab, pos0, finit, cinit, carrbase, *,
                          n_blocks: int, blkp: int, code_length: int,
                          phases_per_chip: int, spacing: float,
                          span_chips: float, base_code_step: float,
                          fs: float, coefs):
    """Plain PyTorch version of K1 (same algorithm, block loop in Python)."""
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
    ia = torch.arange(-(-blkp // 64), dtype=torch.int64, device=dev)
    ir = torch.arange(64, dtype=torch.int64, device=dev)
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

        # Exact-u32 factored LO, angles from the int32 view of the phase.
        ka = (ph[:, None] + ia[None, :] * ((cstep * 64) & U32_MASK)[:, None]
              ) & U32_MASK
        kr = (ir[None, :] * cstep[:, None]) & U32_MASK
        aa = u32_to_i32(ka).to(torch.float32) * k["ang_scale"]
        ar = u32_to_i32(kr).to(torch.float32) * k["ang_scale"]
        ca, sa = torch.cos(aa), torch.sin(aa)
        cr, sr = torch.cos(ar), torch.sin(ar)
        lo_c = (ca[:, :, None] * cr[:, None, :]
                - sa[:, :, None] * sr[:, None, :]).reshape(C, -1)[:, :blkp]
        lo_s = (sa[:, :, None] * cr[:, None, :]
                + ca[:, :, None] * sr[:, None, :]).reshape(C, -1)[:, :blkp]
        bb_i = (xi * lo_c + xq * lo_s) * mask
        bb_q = (xq * lo_c - xi * lo_s) * mask
        e_rows, p_rows, l_rows = (tab[ch, r] for r in rows)
        ie = (e_rows * bb_i).sum(1)
        qe = (e_rows * bb_q).sum(1)
        ip = (p_rows * bb_i).sum(1)
        qp = (p_rows * bb_q).sum(1)
        il = (l_rows * bb_i).sum(1)
        ql = (l_rows * bb_q).sum(1)

        ip_prev, qp_prev = st[:, _F_IP_PREV], st[:, _F_QP_PREV]
        cross = ip * qp_prev - ip_prev * qp
        dot = torch.abs(ip * ip_prev + qp * qp_prev)
        freq_err = torch.atan2(cross, dot) * k["inv_pi"]
        denom = torch.where(torch.abs(ip) < 1e-10,
                            torch.full_like(ip, 1e-10), ip)
        carr_err = torch.atan(qp / denom) * k["inv_2pi"]
        carr_nco = (st[:, _F_CARR_NCO] + k["k1"] * carr_err
                    - k["k2"] * st[:, _F_OLD_CARR_ERR] - k["k3"] * freq_err)
        carr_delta = st[:, _F_DOPPLER_BASIS] + carr_nco
        e_env = torch.sqrt(ie * ie + qe * qe)
        l_env = torch.sqrt(il * il + ql * ql)
        code_err = (e_env - l_env) / torch.clamp(e_env + l_env, min=1e-10)
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
        fn.argtypes = ([p, ctypes.c_longlong] + [p] * 9 + [i] * 5
                       + [fl] * 15 + [p])
        fn.restype = ctypes.c_int
        err = built.lib.track_fused_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built


def build():
    """Build (or load) K1's library; returns its cuda_build.BuiltLibrary
    (path, build seconds, nvcc/ptxas log)."""
    return _lib()


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


def track_chunk_fused(chunk, tab, pos0, finit, cinit, carrbase, *,
                      n_blocks: int, blkp: int, code_length: int,
                      phases_per_chip: int, spacing: float,
                      span_chips: float, base_code_step: float, fs: float,
                      coefs):
    """Run K1. coefs = (k1, k2, k3, c_dll_p, c_dll_i).

    CPU tensors run the plain twin; CUDA tensors launch the kernel (on
    torch.cuda.current_stream()) or raise.
    """
    kw = dict(n_blocks=n_blocks, blkp=blkp, code_length=code_length,
              phases_per_chip=phases_per_chip, spacing=spacing,
              span_chips=span_chips, base_code_step=base_code_step, fs=fs,
              coefs=coefs)
    dev = chunk.device
    if dev.type == "cpu":
        return track_chunk_fused_ref(chunk, tab, pos0, finit, cinit,
                                     carrbase, **kw)
    if dev.type != "cuda":
        raise ValueError(f"track_chunk_fused: unsupported device {dev}")
    C, R = tab.shape[0], tab.shape[1]
    _check("chunk", chunk, torch.float32, (chunk.shape[0], 2), dev)
    _check("tab", tab, torch.float32, (C, R, blkp), dev)
    _check("pos0", pos0, torch.int32, (C,), dev)
    _check("finit", finit, torch.float32, (C, NF), dev)
    _check("cinit", cinit, torch.int64, (C,), dev)
    _check("carrbase", carrbase, torch.int64, (C,), dev)
    if n_blocks < 0:
        raise ValueError("n_blocks must be >= 0")
    out = torch.empty((n_blocks, C, NOUT), dtype=torch.float32, device=dev)
    ffin = torch.empty((C, NF), dtype=torch.float32, device=dev)
    pos = torch.empty((C,), dtype=torch.int32, device=dev)
    cph = torch.empty((C,), dtype=torch.int64, device=dev)
    k = _consts(code_length=code_length, phases_per_chip=phases_per_chip,
                spacing=spacing, span_chips=span_chips,
                base_code_step=base_code_step, fs=fs, coefs=coefs)
    built = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = built.lib.track_chunk_fused_cuda(
        chunk.data_ptr(), chunk.shape[0], tab.data_ptr(), pos0.data_ptr(),
        finit.data_ptr(), cinit.data_ptr(), carrbase.data_ptr(),
        out.data_ptr(), ffin.data_ptr(), pos.data_ptr(), cph.data_ptr(),
        C, n_blocks, R, blkp, code_length,
        k["base_code_step"], k["inv_fs"], k["nco_scale"], k["ph"],
        *k["row_off"], k["ang_scale"], k["inv_pi"], k["inv_2pi"],
        k["k1"], k["k2"], k["k3"], k["c_dll_p"], k["c_dll_i"], stream)
    if rc != 0:
        msg = built.lib.track_fused_error_string(rc).decode()
        raise RuntimeError(f"track_chunk_fused launch failed: {msg} ({rc})")
    LAUNCHES["track_chunk_fused"] += 1
    return out, ffin, pos, cph
