"""Sample sources: the host feed into the device pipeline (port of the
packed sources of gnsstpu/runtime/sources.py).

Random-access read(start, count) sources; packed wire-format sources also
serve read_packed() bytes, which the ChannelManager ships to the device
and unpacks there. ArraySource, FileSource and decode_samples are copied
from the reference module, with its native codecs replaced by their
NumPy fallbacks (gnsstpu_torch.ops.wire).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gnsstpu_torch.device import resolve_device
from gnsstpu_torch.ops import unpack as up


class ArraySource:
    """In-memory source over an iq32 [N, 2] (or complex, converted) array."""

    def __init__(self, samples: np.ndarray):
        samples = np.asarray(samples)
        if np.iscomplexobj(samples):
            from gnsstpu_torch.ops.iq import complex_to_iq
            samples = complex_to_iq(samples)
        self.samples = np.asarray(samples, np.float32).reshape(-1, 2)

    def read(self, start: int, count: int) -> np.ndarray:
        out = np.zeros((count, 2), np.float32)
        lo = max(start, 0)
        hi = min(start + count, len(self.samples))
        if hi > lo:
            out[lo - start: hi - start] = self.samples[lo:hi]
        return out

    def __len__(self) -> int:
        return len(self.samples)


class FileSource:
    """Raw IF sample file source.

    Formats (reference initSettings.sci fileType / defines.h; packed
    front-end formats decoded by gnsstpu_torch.ops.wire):
      'i8_iq'       — interleaved signed 8-bit I,Q pairs (fileType 2)
      'i8'          — signed 8-bit real samples (fileType 1)
      'i16_iq'      — interleaved signed 16-bit I,Q
      'c64'         — raw complex64
      'gn3s_2bit'   — 1 byte/sample: I bits 1:0, Q bits 3:2, LUT
                      {-3,-1,+1,+3} (gps_source.cpp:692)
      'packed_4bit' — CPLD-packed real: LE u16 words of 4 x 4-bit
                      sign/mag samples (data_packer.vhd)
    """

    _ITEM = {"i8_iq": (np.int8, 2), "i8": (np.int8, 1),
             "i16_iq": (np.int16, 2), "c64": (np.complex64, 1),
             "gn3s_2bit": (np.uint8, 1), "packed_4bit": (np.uint16, 1)}

    def __init__(self, path: str, fmt: str = "i8_iq", skip_samples: int = 0):
        if fmt not in self._ITEM:
            raise ValueError(f"unknown format {fmt!r}")
        self.path = path
        self.fmt = fmt
        self.skip = skip_samples
        dtype, per = self._ITEM[fmt]
        self._dtype, self._per = dtype, per
        if fmt == "packed_4bit":
            size = os.path.getsize(path)
            self._n = size // 2 * 4 - skip_samples
        else:
            self._bytes_per_sample = np.dtype(dtype).itemsize * per
            self._n = (os.path.getsize(path) // self._bytes_per_sample
                       - skip_samples)

    def read(self, start: int, count: int) -> np.ndarray:
        from gnsstpu_torch.ops import wire

        start += self.skip
        out = np.zeros((count, 2), np.float32)
        if self.fmt == "packed_4bit":
            w0, w1 = start // 4, -(-(start + count) // 4)
            raw = np.fromfile(self.path, dtype=np.uint16,
                              count=w1 - w0, offset=2 * w0)
            dec = wire.decode_packed_4bit(raw)
            got = dec[start - 4 * w0: start - 4 * w0 + count]
            out[: len(got)] = got
            return out
        raw = np.fromfile(
            self.path, dtype=self._dtype,
            count=count * self._per,
            offset=start * self._bytes_per_sample)
        n = len(raw) // self._per
        if self.fmt == "c64":
            out[:n, 0] = raw[:n].real
            out[:n, 1] = raw[:n].imag
        elif self.fmt == "gn3s_2bit":
            out[:n] = wire.decode_gn3s_2bit(raw[:n])
        elif self.fmt == "i8_iq":
            out[:n] = wire.decode_i8_iq(raw[: 2 * n])
        elif self.fmt == "i16_iq":
            out[:n] = wire.decode_i16_iq(raw[: 2 * n])
        else:
            out[:n, 0] = raw[:n]
        return out

    def __len__(self) -> int:
        return self._n


def decode_samples(raw: bytes, fmt: str) -> np.ndarray:
    """Decode a raw byte buffer in a FileSource wire format to f32
    [n, 2] (whole samples only; callers keep their own byte residue)."""
    from gnsstpu_torch.ops import wire

    if fmt == "i8_iq":
        n = len(raw) // 2
        return wire.decode_i8_iq(np.frombuffer(raw, np.int8,
                                                 count=2 * n))
    if fmt == "i16_iq":
        n = len(raw) // 4
        return wire.decode_i16_iq(np.frombuffer(raw, np.int16,
                                                  count=2 * n))
    if fmt == "gn3s_2bit":
        return wire.decode_gn3s_2bit(np.frombuffer(raw, np.uint8))
    if fmt == "c64":
        n = len(raw) // 8
        c = np.frombuffer(raw, np.complex64, count=n)
        out = np.empty((n, 2), np.float32)
        out[:, 0], out[:, 1] = c.real, c.imag
        return out
    if fmt == "i8":
        v = np.frombuffer(raw, np.int8).astype(np.float32)
        out = np.zeros((len(v), 2), np.float32)
        out[:, 0] = v
        return out
    if fmt == "packed_4bit":
        nw = len(raw) // 2
        return wire.decode_packed_4bit(
            np.frombuffer(raw, np.uint16, count=nw))
    raise ValueError(f"unknown format {fmt!r}")


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
