"""Host tracking driver: chunked streaming around the device trackers
(port of gnsstpu/tracking/driver.py).

track() reads multi-hundred-ms chunks of samples, runs every (block x
channel) of a chunk in one tracker call on the device (kernel K1 for the
fused engine, the exact scan engine for 'gather' / 'table'), reads the
chunk's outputs back in one copy, and keeps on the host the float64
absolute-sample bookkeeping that pseudoranges need (the reference's
tracking.sci:343-345). Each chunk is rebased at the slowest channel; its
margin (one code period plus the differential code-Doppler drift of the
whole run, plus two samples) keeps every channel's blocks inside it,
where the kernels (which read zeros past a chunk) and the scan engines
(which clamp their windows as jax.lax.dynamic_slice does) read the same
samples. run_chunks is that loop, shared by track, tracking.boc.track_boc
and tracking.dual.track_dual.

The fused engines (and the scan's 'table' mode) correlate each block
against one phase row of taps that run at the nominal code rate, while
the signal's code runs at nominal + code Doppler: the replica slips by
code_delta / fs chips a sample. Its DLL centres the replica on the block
as a whole, so the phase it reports at the block's end runs ahead of the
code by half the block's slip. The drivers take that half slip
(replica_slip_samples) off abs_sample for those engines; the exact
'gather' engine needs none. On the card this brought the offline fixes
of the fused engines to the exact engine's (PERF.md); the
reference's drivers have no such term, and the live ChannelManager's
history keeps the reference's observable.

A source whose read() returns numpy is uploaded once per chunk; one that
returns a tensor on the device (sources.DeviceArraySource) is used as it
is, as the ChannelManager does.

Deviation: 'auto' means the fused engine on every device
(tracking.engines.resolve_engine), so a CUDA device launches K1 and the
CPU runs its plain twin. The reference's 'auto' means its scan engine off
the TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from gnsstpu_torch.config import SignalConfig, TrackConfig
from gnsstpu_torch.device import resolve_device, u32_tensor
from gnsstpu_torch.ops import code_tables
from gnsstpu_torch.tracking import scan as tscan
from gnsstpu_torch.tracking.engines import resolve_engine


@dataclasses.dataclass
class ChannelInit:
    """Acquisition handoff for one channel (preRun.sci equivalent)."""

    prn: int
    code_phase: int      # samples, 0-based offset of code start in the stream
    doppler_hz: float    # acquired carrier frequency minus this channel's IF
    # FDMA carrier offset from sig.if_freq [Hz] (0 for CDMA; GLONASS:
    # k * L1_IF_step, reference GLONASS/L1/initSettings.sci).
    if_offset_hz: float = 0.0


@dataclasses.dataclass
class TrackResults:
    """Struct-of-arrays tracking record, [C, n_ms] (tracking.sci:43-83)."""

    prn: np.ndarray            # [C] int
    status: np.ndarray         # [C] bool (tracked)
    i_e: np.ndarray
    q_e: np.ndarray
    i_p: np.ndarray
    q_p: np.ndarray
    i_l: np.ndarray
    q_l: np.ndarray
    carr_freq: np.ndarray      # absolute [Hz]
    code_freq: np.ndarray      # absolute [Hz]
    abs_sample: np.ndarray     # f64 absolute sample of code start per ms
    dll_disc: np.ndarray
    dll_disc_filt: np.ndarray
    pll_disc: np.ndarray
    pll_disc_filt: np.ndarray


def chunk_samples(sig: SignalConfig, n_blocks: int, chunk_blocks: int,
                  period_s: float = 1e-3) -> int:
    """Samples of one chunk of chunk_blocks code periods of period_s: the
    blocks, one code period of initial code-phase spread, the worst
    differential code-Doppler drift over all n_blocks (2e-5 of fs), 64
    samples and the two-sample window overhang (the reference's
    chunk_len)."""
    spc = sig.samples_per_code
    drift = int(np.ceil(n_blocks * period_s * 2e-5 * sig.fs)) + 64
    return chunk_blocks * spc + spc + drift + 2


def replica_slip_samples(code_delta: np.ndarray, blksize: np.ndarray,
                         code_freq: float) -> np.ndarray:
    """Samples by which a replica whose taps run at the nominal code rate
    through a block reports the code start early: half its slip over the
    block, code_delta / fs chips a sample over (blksize - 1) samples, at
    fs / code_freq samples a chip. Arrays [C, n_blocks]; code_freq is the
    nominal rate of the code whose phase the record carries."""
    return (code_delta.astype(np.float64)
            * (blksize.astype(np.float64) - 1.0) / (2.0 * code_freq))


def to_device(buf, device: torch.device) -> torch.Tensor:
    """f32 [N, 2] samples on `device`: numpy is uploaded, a tensor already
    there is used as it is."""
    if isinstance(buf, torch.Tensor):
        return buf.to(device, torch.float32)
    return torch.as_tensor(np.asarray(buf, np.float32), device=device)


def run_chunks(source, tracker: Callable, state, code_phase, *,
               chunk_len: int, n_chunks: int, device: torch.device):
    """The chunk loop of the offline drivers.

    tracker(chunk, state) -> (state, {name: [n_blocks, C] tensor}), one
    name being 'blksize'. Each chunk starts at the slowest channel's
    absolute position, every channel's cursor set relative to it; all of
    the chunk's outputs come back in one device-to-host copy.

    Returns ({name: [C, n_chunks * n_blocks] numpy}, ends), ends [C, ..]
    f64 the absolute stream position after each block.
    """
    abs_pos = np.asarray(code_phase, np.float64)
    parts, ends_all, names = [], [], None
    for _ in range(n_chunks):
        s0 = int(abs_pos.min())
        chunk = to_device(source.read(s0, chunk_len), device)
        rel = np.round(abs_pos - s0).astype(np.int64)
        state = state._replace(corr=state.corr._replace(
            sample_pos=torch.as_tensor(rel.astype(np.int32),
                                       device=device)))
        state, fields = tracker(chunk, state)
        names = list(fields)
        host = torch.stack([fields[k].to(torch.float32)
                            for k in names]).cpu().numpy()
        blk = host[names.index("blksize")].astype(np.float64)
        ends = s0 + rel[None, :] + np.cumsum(blk, axis=0)
        parts.append(host)
        ends_all.append(ends)
        abs_pos = ends[-1]
    host = np.concatenate(parts, axis=1)
    return ({k: host[i].T for i, k in enumerate(names)},
            np.concatenate(ends_all, axis=0).T)


def track(source, channels: Sequence[ChannelInit], sig: SignalConfig,
          trk: TrackConfig, n_ms: int, chunk_ms: int = 256,
          code_mode: str = "auto", *, device="cuda") -> TrackResults:
    """Track all channels for n_ms code periods on `device` ('cuda', the
    default, raises on a host without a card; or 'cpu').

    source: a sample source (gnsstpu_torch.runtime.sources).
    code_mode: 'auto' or 'fused' (kernel K1; its plain twin on the CPU),
    'gather' (the exact scan engine) or 'table' (the scan engine on
    phase-row tables).
    """
    dev = resolve_device(device)
    code_mode = resolve_engine(code_mode)
    prns = [ch.prn for ch in channels]
    if code_mode == "fused":
        from gnsstpu_torch.tracking.fused import (fused_code_table,
                                                  fused_tap_rows,
                                                  make_fused_tracker)
        # K1's int8 rows [C, R, plane_stride(blkp)], built for these PRNs.
        codes = fused_tap_rows(fused_code_table(sig, trk, prns))
        step = make_fused_tracker(sig, trk, n_blocks=chunk_ms)
    else:
        if code_mode == "table":
            tab = code_tables.phase_row_table(
                sig.signal, sig.fs, sig.code_freq, sig.code_length,
                sig.samples_per_code + 2)
        else:
            tab = code_tables.padded_code_table(sig.signal)
        codes = np.stack([tab[p - 1] for p in prns]).astype(np.float32)
        step = tscan.make_tracker(sig, trk, n_blocks=chunk_ms,
                                  code_mode=code_mode)
    codes = torch.as_tensor(codes, device=dev)
    carr_base, inv_aid = tscan.channel_consts(
        sig, trk, prns, if_offsets_hz=[ch.if_offset_hz for ch in channels])
    consts = (u32_tensor(carr_base, dev), torch.as_tensor(inv_aid,
                                                          device=dev))
    state = tscan.TrackState.init(
        np.array([ch.code_phase for ch in channels], np.int64),
        np.array([ch.doppler_hz for ch in channels], np.float32),
        aid_div=trk.aid_div, device=dev)

    def tracker(chunk, st):
        st, out = step(chunk, codes, consts, st)
        return st, out._asdict()

    f, ends = run_chunks(
        source, tracker, state, [ch.code_phase for ch in channels],
        chunk_len=chunk_samples(sig, n_ms, chunk_ms),
        n_chunks=int(np.ceil(n_ms / chunk_ms)), device=dev)
    f = {k: v[:, :n_ms] for k, v in f.items()}
    rem = f["rem_code_phase"].astype(np.float64)
    # absoluteSample: stream position after the block minus the code-phase
    # remainder in samples (tracking.sci:343-345).
    abs_sample = ends[:, :n_ms] - rem * (sig.fs / 1e3) / sig.code_length
    if code_mode != "gather":
        abs_sample = abs_sample + replica_slip_samples(
            f["code_freq_delta"], f["blksize"], sig.code_freq)
    return TrackResults(
        prn=np.array(prns),
        status=np.ones(len(channels), bool),
        i_e=f["ie"], q_e=f["qe"], i_p=f["ip"], q_p=f["qp"],
        i_l=f["il"], q_l=f["ql"],
        carr_freq=(sig.if_freq
                   + np.array([ch.if_offset_hz for ch in channels]
                              )[:, None]
                   + f["carr_doppler"].astype(np.float64)),
        code_freq=sig.code_freq + f["code_freq_delta"].astype(np.float64),
        abs_sample=abs_sample,
        dll_disc=f["dll_disc"],
        dll_disc_filt=f["dll_disc_filt"],
        pll_disc=f["pll_disc"],
        pll_disc_filt=f["pll_disc_filt"],
    )
