"""Rational-rate IF resampling, front-end rate -> processing rate (port of
gnsstpu/ops/resample.py).

Two modes, as the reference's:

  * ``nearest``: the nearest input sample per output tick (zero-order
    hold, no anti-alias filter), the reference receiver's
    Resample_USRP_V1 index table (objects/gps_source.cpp:436).
  * ``polyphase``: anti-aliased rational P/Q conversion with a
    Kaiser-windowed-sinc prototype, a gather of K taps per output sample
    and a weighted sum over them.

The bank, the window and the index table are numpy, identical to the
reference's. The apply (the reference's jitted gather + einsum) is plain
torch on `device` ('cuda' by default; a CUDA request on a host without a
card raises). It holds a [count, K, 2] f32 window, so the outputs are
taken in pieces whose window stays under _WINDOW_BYTES: at 16 Msps ->
2.048 Msps (K = 250) an unsplit 4 s chunk would hold ~16 GB. On the card
each ResampledSource runs its applies on a CUDA stream of its own, so a
producer thread's copy back to the host does not queue behind the
tracking kernels on the default stream.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from gnsstpu_torch.device import resolve_device

#: Most bytes one piece's gathered [count, K, 2] f32 window may hold.
_WINDOW_BYTES = 256 << 20


def rational_ratio(fs_in: float, fs_out: float,
                   max_den: int = 1 << 16) -> tuple:
    """(p, q) with fs_out/fs_in ~= p/q, reduced."""
    r = Fraction(fs_out / fs_in).limit_denominator(max_den)
    return r.numerator, r.denominator


def kaiser_lowpass(n_taps: int, cutoff: float, beta: float = 8.6
                   ) -> np.ndarray:
    """Kaiser-windowed sinc lowpass, unit DC gain.

    cutoff is normalized to Nyquist (1.0 = fs/2). No scipy: the Kaiser
    window uses np.i0 directly.
    """
    m = np.arange(n_taps, dtype=np.float64)
    center = (n_taps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * (m - center))
    x = 2.0 * m / (n_taps - 1) - 1.0
    w = np.i0(beta * np.sqrt(np.maximum(1.0 - x * x, 0.0))) / np.i0(beta)
    h = h * w
    return h / h.sum()


class PolyphaseBank:
    """Prototype lowpass split into p phases of K taps each.

    The prototype runs at the upsampled rate p*fs_in with cutoff
    min(fs_in, fs_out)/2; gain p restores unit passband after the
    zero-stuffing model. Odd prototype length (K*p - 1) keeps the group
    delay an integer number of upsampled samples, so resampled output
    sample n is time-aligned with input time n*q/p exactly.
    """

    def __init__(self, p: int, q: int, taps_per_phase: int = None,
                 beta: float = 8.6):
        if taps_per_phase is None:
            # ~32 taps at the *slower* of the two rates, so decimators
            # get a sharp enough prototype (droop < 1% in band)
            taps_per_phase = max(32, 2 * int(np.ceil(16.0 * q / p)))
        if taps_per_phase % 2:
            taps_per_phase += 1
        self.p, self.q, self.K = p, q, taps_per_phase
        L = taps_per_phase * p - 1
        cutoff = 1.0 / max(p, q)  # of upsampled Nyquist p*fs_in/2
        h = kaiser_lowpass(L, cutoff) * p
        h = np.concatenate([h, [0.0]])
        # bank[k, phase] = h[k*p + phase]
        self.bank = np.asarray(h.reshape(taps_per_phase, p), np.float32)
        self.group_delay_up = L // 2  # integer, in upsampled samples

    def phases(self, start_out: int, count: int):
        """(base_idx [count], phase [count]) for outputs
        [start_out, start_out+count): output n's weights are row
        phase[n] of rows(), its samples x[base[n]:base[n]+K]."""
        n = np.arange(start_out, start_out + count, dtype=np.int64)
        t = n * self.q + self.group_delay_up
        b = t // self.p
        phase = (t - b * self.p).astype(np.int32)
        # y[n] = sum_k h[phase + p*k] x[b - k]  ->  ascending-index form
        base = (b - (self.K - 1)).astype(np.int64)
        return base, phase

    def rows(self) -> np.ndarray:
        """[p, K] weight rows in ascending-sample order, one per phase."""
        return np.ascontiguousarray(self.bank[::-1, :].T)

    def window(self, start_out: int, count: int):
        """(base_idx [count], weights [count, K]) for outputs
        [start_out, start_out+count): y[n] = sum_k w[n,k] x[base[n]+k]."""
        base, phase = self.phases(start_out, count)
        w = self.bank[::-1, :][:, phase].T  # [count, K]
        return base, np.ascontiguousarray(w)


def apply_window(x: torch.Tensor, rel_base: torch.Tensor, w: torch.Tensor,
                 window_bytes: int = _WINDOW_BYTES) -> torch.Tensor:
    """y[n] = sum_k w[n, k] x[rel_base[n] + k]: x [M, 2] f32, rel_base
    [count] int64 into x, w [count, K] f32, all on one device. The
    outputs are taken in pieces whose gathered window [piece, K, 2] f32
    holds at most window_bytes (at least one output per piece); each
    output's sum is the same whatever the split."""
    count, K = w.shape
    piece = max(1, window_bytes // (K * 2 * 4))
    k = torch.arange(K, dtype=torch.int64, device=x.device)
    out = torch.empty((count, 2), dtype=torch.float32, device=x.device)
    for n0 in range(0, count, piece):
        n1 = min(n0 + piece, count)
        win = x[rel_base[n0:n1, None] + k[None, :]]       # [n, K, 2]
        out[n0:n1] = torch.einsum("nk,nkc->nc", w[n0:n1], win)
    return out


def polyphase_resample(x: np.ndarray, p: int, q: int,
                       taps_per_phase: int = None, *,
                       device="cuda") -> np.ndarray:
    """Whole-array rational resample of iq [N, 2] to ceil(N*p/q) samples,
    the apply on `device`."""
    dev = resolve_device(device)
    bank = PolyphaseBank(p, q, taps_per_phase)
    n_out = -(-len(x) * p // q)
    base, phase = bank.phases(0, n_out)
    lo = int(base.min())
    pad_lo = max(-lo, 0)
    hi = int(base.max()) + bank.K
    pad_hi = max(hi - len(x), 0)
    xp = np.pad(np.asarray(x, np.float32), ((pad_lo, pad_hi), (0, 0)))
    w = torch.as_tensor(bank.rows(), device=dev)[
        torch.as_tensor(phase, device=dev).long()]
    out = apply_window(torch.as_tensor(xp, device=dev),
                       torch.as_tensor(base + pad_lo, device=dev), w)
    return out.cpu().numpy()


def nearest_indices(fs_in: float, fs_out: float, start_out: int,
                    count: int) -> np.ndarray:
    """Input sample index per output tick (Resample_USRP_V1 semantics:
    zero-order-hold index table, gps_source.cpp:436)."""
    n = np.arange(start_out, start_out + count, dtype=np.float64)
    return np.floor(n * (fs_in / fs_out) + 0.5).astype(np.int64)


class ResampledSource:
    """SampleSource adapter: serve an inner source at a new rate.

    mode 'polyphase' (anti-aliased rational P/Q, applied on `device`) or
    'nearest' (reference-compatible zero-order hold, on the host). The
    polyphase weights are gathered on the device from the bank's p rows
    (the same values as PolyphaseBank.window), so only the input samples
    and one phase index per output cross the host link.
    """

    def __init__(self, inner, fs_in: float, fs_out: float,
                 mode: str = "polyphase", taps_per_phase: int = None, *,
                 device="cuda"):
        if mode not in ("polyphase", "nearest"):
            raise ValueError(f"unknown mode {mode!r}")
        self.inner = inner
        self.fs_in, self.fs_out = fs_in, fs_out
        self.mode = mode
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._n = int(len(inner) * fs_out / fs_in)
        if mode == "polyphase":
            p, q = rational_ratio(fs_in, fs_out)
            self.p, self.q = p, q
            self.bank = PolyphaseBank(p, q, taps_per_phase)
            self._rows = torch.as_tensor(self.bank.rows(),
                                         device=self.device)

    def read(self, start: int, count: int) -> np.ndarray:
        if self.mode == "nearest":
            idx = nearest_indices(self.fs_in, self.fs_out, start, count)
            lo = int(idx[0])
            x = self._read_padded(lo, int(idx[-1]) - lo + 1)
            return x[idx - lo]
        base, phase = self.bank.phases(start, count)
        lo = int(base.min())
        hi = int(base.max()) + self.bank.K
        x = self._read_padded(lo, hi - lo)
        if self._stream is None:
            return self._apply(x, base - lo, phase).numpy()
        with torch.cuda.stream(self._stream):
            return self._apply(x, base - lo, phase).cpu().numpy()

    def _apply(self, x, rel_base, phase) -> torch.Tensor:
        dev = self.device
        w = self._rows[torch.as_tensor(phase, device=dev).long()]
        return apply_window(torch.as_tensor(x, device=dev),
                            torch.as_tensor(rel_base, device=dev), w)

    def _read_padded(self, start: int, count: int) -> np.ndarray:
        """inner.read that also zero-pads before sample 0 (file sources
        cannot seek negative)."""
        if start >= 0:
            return self.inner.read(start, count)
        out = np.zeros((count, 2), np.float32)
        if count + start > 0:
            out[-start:] = self.inner.read(0, count + start)
        return out

    def __len__(self) -> int:
        return self._n
