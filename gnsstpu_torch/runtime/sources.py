"""Sample sources: the host feed into the device pipeline (port of the
packed sources of gnsstpu/runtime/sources.py).

Random-access read(start, count) sources; packed wire-format sources also
serve read_packed() bytes, which the ChannelManager ships to the device
and unpacks there. ArraySource and FileSource have no JAX in them and are
re-exported from the reference module.
"""

from __future__ import annotations

import numpy as np
import torch

from gnsstpu.runtime.sources import ArraySource, FileSource  # noqa: F401
from gnsstpu_torch.device import resolve_device
from gnsstpu_torch.ops import unpack as up


class _PackedReadMixin:
    """Decoded f32 read() over read_packed() for host consumers
    (fine-Doppler refinement, host-path acquisition). Samples outside
    [0, len(self)) are zero: packed zero BYTES decode to nonzero levels,
    so the out-of-range span is zeroed explicitly."""

    def read(self, start: int, count: int) -> np.ndarray:
        a = up.align(self._fmt)
        s0 = start - start % a
        n = count + (start - s0)
        n += (-n) % a
        dec = up.unpack_np(self.read_packed(s0, n), self._fmt)
        out = np.array(dec[start - s0: start - s0 + count])
        lo = max(0, -start)
        hi = max(0, min(count, len(self) - start))
        out[:lo] = 0.0
        out[hi:] = 0.0
        return out


class PackedArraySource(_PackedReadMixin):
    """In-memory packed wire-format source: read_packed() returns host
    uint8 bytes, which the manager uploads and unpacks on the device."""

    def __init__(self, samples_iq: np.ndarray, fmt: str = "sm2",
                 scale: float = 1.0):
        self.wire_format = fmt
        self._fmt = fmt
        n = len(samples_iq)
        n -= n % up.align(fmt)
        self.packed = up.pack(np.asarray(samples_iq)[:n], fmt, scale)
        self._n = n
        self._spb = up.samples_per_byte(fmt)

    def read_packed(self, start: int, count: int) -> np.ndarray:
        """Packed bytes covering samples [start, start+count); both must
        be aligned to the format's samples-per-byte."""
        a = up.align(self._fmt)
        if start % a or count % a:
            raise ValueError(f"unaligned packed read ({start}, {count})")
        b0 = int(start / self._spb)
        nb = int(count / self._spb)
        out = np.zeros(nb, np.uint8)
        seg = self.packed[max(b0, 0): b0 + nb]
        out[max(-b0, 0): max(-b0, 0) + len(seg)] = seg
        return out

    def __len__(self) -> int:
        return self._n


class DevicePackedArraySource:
    """Packed wire-format source resident in device memory.

    The packed byte stream is uploaded once; read_packed() serves device
    slices, so the manager's superepoch feed moves no samples over the
    host link. Host consumers (cold acquisition, fine-Doppler refinement)
    decode a retained host copy. Reads before the start or up to
    tail_pad_samples past the end serve zero bytes, like
    PackedArraySource.read_packed.
    """

    def __init__(self, samples_iq: np.ndarray, fmt: str = "sm2",
                 scale: float = 1.0, tail_pad_samples: int = 1 << 24, *,
                 device="cuda"):
        self.wire_format = fmt
        self._fmt = fmt
        self.device = resolve_device(device)
        n = len(samples_iq)
        n -= n % up.align(fmt)
        self.packed = up.pack(np.asarray(samples_iq)[:n], fmt, scale)
        self._spb = up.samples_per_byte(fmt)
        self._pad_b = int(tail_pad_samples / self._spb)
        self.packed_dev = torch.zeros(len(self.packed) + self._pad_b,
                                      dtype=torch.uint8, device=self.device)
        self.packed_dev[: len(self.packed)] = torch.from_numpy(self.packed)
        self._n = n

    def read_packed(self, start: int, count: int) -> torch.Tensor:
        """Device uint8 tensor covering samples [start, start+count)."""
        a = up.align(self._fmt)
        if start % a or count % a:
            raise ValueError(f"unaligned packed read ({start}, {count})")
        b0 = int(start / self._spb)
        nb = int(count / self._spb)
        if b0 + nb > len(self.packed) + self._pad_b:
            raise ValueError(
                f"read past the device buffer's tail pad "
                f"({start}+{count} vs {self._n}+pad)")
        if b0 < 0:
            nb_avail = max(nb + b0, 0)
            return torch.cat([
                torch.zeros(nb - nb_avail, dtype=torch.uint8,
                            device=self.device),
                self.packed_dev[:nb_avail]])
        return self.packed_dev[b0: b0 + nb]

    def read(self, start: int, count: int) -> np.ndarray:
        out = np.zeros((count, 2), np.float32)
        if start < 0:
            lead = min(-start, count)
            if count > lead:
                out[lead:] = self.read(0, count - lead)
            return out
        a = up.align(self._fmt)
        s0 = start - start % a
        n = count + (start - s0)
        n += (-n) % a
        b0 = int(s0 / self._spb)
        seg = self.packed[b0: b0 + int(n / self._spb)]
        dec = up.unpack_np(seg, self._fmt)
        got = dec[start - s0: start - s0 + count]
        out[: len(got)] = got
        return out

    def __len__(self) -> int:
        return self._n
