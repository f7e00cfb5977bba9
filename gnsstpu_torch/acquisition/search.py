"""Cold-start acquisition: FFT code-phase x Doppler search over all PRNs
(acquire, CDMA) or all frequency channels (acquire_fdma, GLONASS L1/L2 OF)
(port of gnsstpu/acquisition/search.py).

Detection logic as the reference: B coherent windows (max-combined
alternating windows, or sum-combined noncoherent), peak / second-peak
ratio against a threshold, and the (code phase [samples], carrier
frequency [Hz]) handoff to tracking.

Deviations: acquire() on an FDMA signal raises ValueError naming
acquire_fdma. The reference would search a per-PRN code bank against one
Doppler grid around IF there, which finds no frequency channel but the
zero one. On a signal whose satellites send a data code beside the pilot
(GLONASS L3OC: code prn + 32, in quadrature at equal power), each
satellite is detected on the sum of its pilot and data codes' power at
every (Doppler, lag) cell (combine_components), and its carrier is
refined before the handoff even when the configuration asks for no fine
Doppler (fine_doppler_ms); the reference detects on the pilot code alone,
which at 48 dB-Hz, 1 ms and 2-bit samples misses a satellite in a few
percent of cold searches, and hands over the bin's frequency, up to a
bin off, which an on-chunk search carries forward at the wrong code rate.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from gnsstpu_torch.config import AcqConfig, SignalConfig
from gnsstpu_torch.signals.registry import get_signal
from gnsstpu_torch.device import resolve_device
from gnsstpu_torch.ops import fft_acquire


@dataclasses.dataclass
class AcqResults:
    """Per-PRN acquisition outcome (index 0 = PRN 1), host numpy."""

    peak_metric: np.ndarray   # [P] peak/second-peak ratio
    code_phase: np.ndarray    # [P] samples (0-based offset of code start)
    carr_freq: np.ndarray     # [P] acquired carrier frequency [Hz]
    detected: np.ndarray      # [P] bool
    codes: int = 0            # code rows the search correlated
    combined: bool = False    # pilot and data powers summed

    def detected_prns(self) -> list:
        return [int(p) + 1 for p in np.nonzero(self.detected)[0]]


def data_code_offset(signal: str) -> Optional[int]:
    """Code-bank offset of each satellite's data code from its pilot
    code, for a signal that sends both (GLONASS L3OC: code prn + 32), else
    None."""
    if signal != "glonass_l3oc":
        return None
    from gnsstpu_torch.signals import glonass_l3

    return glonass_l3.data_prn(1) - glonass_l3.pilot_prn(1)


def combine_components(cube: torch.Tensor, signal: str,
                       first_data: Optional[int] = None) -> bool:
    """In place on a [R, D, S] power cube: add each data code's power
    into its pilot code's row at every (Doppler, lag) cell, for a signal
    that sends both (data_code_offset); the data rows are left as they
    are. The two codes share the carrier and the code start, and neither
    overlay flips inside a window that starts at the code start, so the
    pilot row then holds the satellite's whole power. The cube's rows are
    the whole code bank (first_data None), or bank_rows' rows with
    first_data its index of the first data row. Returns whether it
    combined (False: the cube is untouched)."""
    off = data_code_offset(signal)
    if off is None:
        return False
    start = off if first_data is None else first_data
    cube[:cube.shape[0] - start] += cube[start:]
    return True


def bank_rows(signal: str, num_prn: int, prns) -> tuple:
    """(rows, first_data): the code-bank rows a search for `prns` needs,
    for combine_components. rows: each PRN's pilot row p - 1, ascending,
    then, for a signal that sends a data code (data_code_offset), the
    data row p - 1 + offset of each pilot that has one in the bank, in the
    same order, which makes the pilots with a data row the leading ones;
    the whole bank instead where that is no fewer rows. first_data: the
    index of the first data row in rows (None: no data code)."""
    pilots = sorted({p - 1 for p in prns})
    off = data_code_offset(signal)
    if off is None:
        return pilots, None
    rows = pilots + [r + off for r in pilots if r + off < num_prn]
    if len(rows) >= num_prn:
        return list(range(num_prn)), off
    return rows, len(pilots)


#: Code periods of fine Doppler before a pilot + data signal's handoff
#: when the configuration asks for none: 10 squared 1 ms pilot prompts
#: resolve up to +-250 Hz (a bin is 250 Hz) to a few Hz at 48 dB-Hz.
DUAL_FINE_DOPPLER_MS = 10


def fine_doppler_ms(sig: SignalConfig, acq: AcqConfig) -> int:
    """Code periods of fine Doppler before handoff (0: none): the
    configuration's, or DUAL_FINE_DOPPLER_MS for a signal that sends a
    data code beside the pilot (data_code_offset) when it asks for
    none."""
    if acq.fine_doppler_ms > 0 or data_code_offset(sig.signal) is None:
        return acq.fine_doppler_ms
    return DUAL_FINE_DOPPLER_MS


def _windows_of(acq: AcqConfig) -> tuple:
    """(n_windows, combine): noncoherent > 1 -> sum-combined; otherwise
    max-combined windows (2 = alternating bit-flip dodge)."""
    if acq.noncoherent > 1:
        return acq.noncoherent, "sum"
    return (acq.n_windows or 2), "max"


def acq_samples_needed(sig: SignalConfig, acq: AcqConfig) -> int:
    """Leading samples acquire() consumes (B coherent windows + tail)."""
    spc = sig.samples_per_code
    B, _ = _windows_of(acq)
    base = (B - 1) * acq.coherent_ms * spc + fft_acquire.window_len(
        spc, acq.coherent_ms)
    return max(base, (fine_doppler_ms(sig, acq) + 1) * spc)


def refine_doppler(samples_iq: np.ndarray, sig: SignalConfig, prn: int,
                   code_phase: int, coarse_carr_hz: float,
                   k_ms: int = 10, iters: int = 2) -> float:
    """Fine carrier frequency from squared prompt accumulations (host
    numpy, copied from the reference): wipe code and coarse carrier off
    k_ms code periods, square each period's prompt to strip data flips,
    and estimate the residual from the mean phase advance. Returns the
    refined absolute carrier frequency [Hz]."""
    from gnsstpu_torch.ops import code_tables

    spc = sig.samples_per_code
    n = k_ms * spc
    x = samples_iq[code_phase: code_phase + n]
    if x.shape[0] < n:
        raise ValueError("not enough samples for fine Doppler")
    table = code_tables.sampled_code_table(
        sig.signal, sig.fs, sig.code_freq, sig.code_length)
    code = np.tile(table[prn - 1].astype(np.float64), k_ms)
    xc = (x[:, 0].astype(np.float64) + 1j * x[:, 1]) * code
    t = np.arange(n, dtype=np.float64) / sig.fs
    T = spc / sig.fs
    carr = coarse_carr_hz
    for _ in range(iters):
        w = xc * np.exp(-2j * np.pi * carr * t)
        p = w.reshape(k_ms, spc).sum(axis=1)
        q = p * p
        acc = np.sum(q[1:] * np.conj(q[:-1]))
        carr += float(np.angle(acc)) / (4.0 * np.pi * T)
    return carr


def code_fd_tensor(sig: SignalConfig, acq: AcqConfig, device
                   ) -> torch.Tensor:
    """complex64 [P, Npad] conj code spectra on `device`, made once a
    process for each signal, front end, coherent length and device, and
    shared: callers read it and never write it. (A cold start at 24 Msps
    would otherwise build 63 x 65,536-point spectra on the host and
    upload their 33 MB for its first search and again for the manager's
    on-chunk searches.)"""
    return _code_fd(sig.signal, sig.fs, sig.code_freq, sig.code_length,
                    acq.coherent_ms, torch.device(device))


@functools.lru_cache(maxsize=16)
def _code_fd(signal: str, fs: float, code_freq: float, code_length: int,
             coherent_ms: int, device: torch.device) -> torch.Tensor:
    fd_re, fd_im = fft_acquire.code_fd_table(signal, fs, code_freq,
                                             code_length, coherent_ms)
    return torch.complex(torch.from_numpy(fd_re),
                         torch.from_numpy(fd_im)).to(device)


def stack_windows(samples: torch.Tensor, spc: int, acq: AcqConfig
                  ) -> torch.Tensor:
    """[B, Lw, 2] coherent windows at stride coherent_ms code periods."""
    B, _ = _windows_of(acq)
    L = acq.coherent_ms * spc
    Lw = fft_acquire.window_len(spc, acq.coherent_ms)
    need = (B - 1) * L + Lw
    if samples.shape[0] < need:
        raise ValueError(f"need >= {need} samples for {B} x "
                         f"{acq.coherent_ms} ms coherent windows")
    return torch.stack([samples[k * L: k * L + Lw] for k in range(B)])


def acquire(samples_iq: np.ndarray, sig: SignalConfig, acq: AcqConfig, *,
            device="cuda") -> AcqResults:
    """Search all PRNs of sig.signal in the leading samples on `device`.

    samples_iq: f32 [N >= acq_samples_needed(sig, acq), 2] host samples.
    device: 'cuda' (the default; raises on a host without a card) or
    'cpu'.
    """
    sd = get_signal(sig.signal)
    if sd.fdma_zero_prn is not None:
        raise ValueError(
            f"{sig.signal} is an FDMA signal: search it with acquire_fdma "
            "(frequency channels share one code)")
    dev = resolve_device(device)
    spc = sig.samples_per_code
    samples = torch.as_tensor(np.array(samples_iq, np.float32),
                              device=dev)
    blocks = stack_windows(samples, spc, acq)
    _, combine = _windows_of(acq)
    dopp = fft_acquire.doppler_grid(sig.if_freq, acq.doppler_band,
                                    acq.doppler_bin_step())
    cube = fft_acquire.acquire_cube(
        blocks, code_fd_tensor(sig, acq, dev),
        torch.as_tensor(dopp, dtype=torch.float32, device=dev),
        sig.fs, spc, combine=combine)
    combined = combine_components(cube, sig.signal)
    m = fft_acquire.peak_metrics(cube, samples_per_code=spc,
                                 samples_per_chip=round(sig.fs
                                                        / sig.code_freq))
    metric = m["metric"].cpu().numpy()
    code_phase = m["code_phase"].cpu().numpy()
    best_bin = m["doppler_bin"].cpu().numpy()
    allowed = np.ones(sd.num_prn, bool)
    if acq.prn_list is not None:
        allowed[:] = False
        allowed[[p - 1 for p in acq.prn_list]] = True
    detected = (metric > acq.threshold) & allowed
    carr = dopp[best_bin].astype(np.float64)
    k_ms = fine_doppler_ms(sig, acq)
    if k_ms > 0:
        for i in np.nonzero(detected)[0]:
            carr[i] = refine_doppler(
                samples_iq, sig, int(i) + 1, int(code_phase[i]), carr[i],
                k_ms=k_ms)
    return AcqResults(peak_metric=metric, code_phase=code_phase,
                      carr_freq=carr, detected=detected,
                      codes=int(cube.shape[0]), combined=combined)


def fdma_grid(sig: SignalConfig, acq: AcqConfig) -> tuple:
    """An FDMA search's carrier grid, channel-major: (offs [K], the carrier
    offset of each frequency channel (registry prn 1..K) from the zero
    channel's; dopp [D], the Doppler grid around 0; grid [K * D], the
    absolute carriers IF + offset + Doppler) [Hz]."""
    sd = get_signal(sig.signal)
    carr_all = np.array([sd.carrier_freq(p)
                         for p in range(1, sd.num_prn + 1)])
    offs = carr_all - sd.carrier_freq(sd.fdma_zero_prn or 1)
    dopp = fft_acquire.doppler_grid(0.0, acq.doppler_band,
                                    acq.doppler_bin_step())
    return offs, dopp, (sig.if_freq + offs[:, None]
                        + dopp[None, :]).reshape(-1)


def acquire_fdma(samples_iq: np.ndarray, sig: SignalConfig, acq: AcqConfig,
                 *, device="cuda") -> AcqResults:
    """FDMA acquisition (GLONASS): search frequency channels, not PRNs.

    All satellites share one ranging code and are separated by carrier
    frequency: one shared code row is searched against the flattened
    [channel x Doppler] carrier grid in one batch of transforms on
    `device` ('cuda', the default, or 'cpu').

    Result index 0 is registry prn 1 (for GLONASS frequency channel
    k = prn - 8). carr_freq includes IF, the channel's FDMA offset from
    the zero channel and the Doppler.
    """
    sd = get_signal(sig.signal)
    dev = resolve_device(device)
    spc = sig.samples_per_code
    samples = torch.as_tensor(np.array(samples_iq, np.float32),
                              device=dev)
    blocks = stack_windows(samples, spc, acq)
    _, combine = _windows_of(acq)
    code_fd = code_fd_tensor(sig, acq, dev)[:1]      # one shared code row
    offs, dopp1, grid = fdma_grid(sig, acq)
    K, D = sd.num_prn, len(dopp1)
    cube = fft_acquire.acquire_cube(
        blocks, code_fd, torch.as_tensor(grid, dtype=torch.float32,
                                         device=dev),
        sig.fs, spc, combine=combine).reshape(K, D, spc)
    m = fft_acquire.peak_metrics(cube, samples_per_code=spc,
                                 samples_per_chip=round(sig.fs
                                                        / sig.code_freq))
    metric = m["metric"].cpu().numpy()
    code_phase = m["code_phase"].cpu().numpy()
    best_bin = m["doppler_bin"].cpu().numpy()
    carr = (offs + dopp1[best_bin] + sig.if_freq).astype(np.float64)
    detected = metric > acq.threshold
    if acq.prn_list is not None:
        allowed = np.zeros(K, bool)
        allowed[[p - 1 for p in acq.prn_list]] = True
        detected &= allowed
    if acq.fine_doppler_ms > 0:
        for i in np.nonzero(detected)[0]:
            carr[i] = refine_doppler(
                samples_iq, sig, int(i) + 1, int(code_phase[i]), carr[i],
                k_ms=acq.fine_doppler_ms)
    return AcqResults(peak_metric=metric, code_phase=code_phase,
                      carr_freq=carr, detected=detected, codes=1)
