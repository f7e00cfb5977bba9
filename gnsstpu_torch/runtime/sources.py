"""Sample sources: the host feed into the device pipeline (port of
gnsstpu/runtime/sources.py).

Random-access read(start, count) sources; packed wire-format sources also
serve read_packed() bytes, which the ChannelManager ships to the device
and unpacks there. The live half is the reference's FIFO fabric: a
producer thread (a UDP or TCP front end, a file reader) pushes 1 ms
blocks into a gnsstpu_torch.native.RingFifo, and StreamSource or
PackedStreamSource serve reads from a rolling history of them. The
classes are the reference's, with its native codecs replaced by their
NumPy fallbacks (gnsstpu_torch.ops.wire) and one deviation: a read longer
than a stream source's history raises ValueError, where the reference
zero-fills its start without an error (size the history from the
manager's chunk, ChannelManager.chunk_samples).
"""

from __future__ import annotations

import os
import time

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


class DeviceArraySource:
    """Source over f32 [N, 2] samples resident on the device: read()
    serves device tensors (zeros outside [0, N)), so the offline drivers
    (tracking.driver.run_chunks) move no samples over the host link.
    Acquisition copies its leading window to the host."""

    def __init__(self, samples: torch.Tensor):
        self.samples = samples.to(torch.float32).reshape(-1, 2)
        self.device = self.samples.device

    def read(self, start: int, count: int) -> torch.Tensor:
        lo = max(start, 0)
        hi = min(start + count, len(self.samples))
        if lo == start and hi - lo == count:
            return self.samples[lo:hi]
        out = torch.zeros((count, 2), dtype=torch.float32,
                          device=self.device)
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


class SimSource:
    """Streaming source over an IFSimulator with block caching."""

    def __init__(self, sim, n_ms: int):
        self.sim = sim
        self.n_ms = n_ms
        self.block = sim.block_samples
        self._cache_ms0 = -1
        self._cache = None
        self._cache_len_ms = 0

    def read(self, start: int, count: int) -> np.ndarray:
        ms0 = max(start // self.block, 0)
        ms1 = min((start + count - 1) // self.block + 1, self.n_ms)
        if ms1 <= ms0:
            # Entirely outside [0, n_ms): zero-pad per the protocol
            # (a negative gen_len would otherwise reach the simulator).
            return np.zeros((count, 2), np.float32)
        if not (self._cache_ms0 <= ms0 and
                ms1 <= self._cache_ms0 + self._cache_len_ms):
            gen_ms0 = ms0
            gen_len = max(ms1 - ms0, min(self.n_ms - ms0, 256))
            self._cache = self.sim.generate(gen_len, gen_ms0)
            self._cache_ms0 = gen_ms0
            self._cache_len_ms = gen_len
        off = start - self._cache_ms0 * self.block
        out = np.zeros((count, 2), np.float32)
        avail = self._cache[max(off, 0): off + count]
        out[max(-off, 0): max(-off, 0) + len(avail)] = avail
        return out

    def __len__(self) -> int:
        return self.n_ms * self.block


def stream_blocks(chunk_samples: int, block_samples: int) -> int:
    """Blocks of a live stream's history and FIFO: two of the manager's
    chunks (ChannelManager.chunk_samples), at least the reference's 1,024
    blocks, so the prefetch pipeline's reads (one chunk ahead of the one
    in flight) stay on the ring."""
    return max(1024, 2 * -(-chunk_samples // block_samples))


def _check_history(count: int, history: int, unit: str) -> None:
    """A read longer than the history would serve its start from ring
    slots that later blocks overwrote (the reference zero-fills them
    without an error): refuse it."""
    if count > history:
        raise ValueError(
            f"read of {count} {unit} is longer than the stream's history "
            f"of {history}: size history_blocks from the manager's chunk "
            "(ChannelManager.chunk_samples)")


class StreamSource:
    """Live streaming source: a producer thread feeds the ring FIFO;
    reads are served from a rolling history window.

    The reference's FIFO/GPS_Source fabric (objects/fifo.cpp:53-187 ring
    of 1 ms packets between the radio thread and the correlator;
    objects/gps_source.cpp:135 Read): the producer (socket, file) pushes
    decoded 1 ms f32 blocks; the consumer keeps its random-access
    read(start, count) protocol against a bounded history, BLOCKING until
    the stream has produced up to start+count.

    Semantics:
      * reads past the producer's current position block (up to
        timeout_s, then TimeoutError, the Patience-watchdog stall signal,
        objects/patience.cpp:80-104);
      * reads of data older than the history window return zeros (it
        fell off the ring);
      * a read longer than the history raises ValueError (port
        deviation: the reference zero-fills its start);
      * producer end-of-stream (FIFO closed and drained) zero-fills, so
        epoch loops terminate via their end-of-data checks.

    stats() surfaces the FIFO's depth and overrun counters for telemetry.
    """

    def __init__(self, fifo, block_samples: int, history_blocks: int = 512,
                 timeout_s: float = 10.0):
        self.fifo = fifo
        self.block = int(block_samples)
        self.hist_blocks = int(history_blocks)
        self.timeout_s = timeout_s
        self._hist = np.zeros((self.hist_blocks * self.block, 2),
                              np.float32)
        self._end = 0            # absolute samples consumed from the FIFO
        self._eos = False
        self._restart_factory = None
        self.restarts = 0

    def set_restart(self, factory) -> "StreamSource":
        """Arm Patience-style recovery: factory() must stop/replace the
        producer and return a STARTED producer feeding this source's
        FIFO (reference patience.cpp:80-104 Stop -> ResetSource ->
        Start). The ChannelManager calls restart() on a stall instead
        of raising."""
        self._restart_factory = factory
        return self

    @property
    def can_restart(self) -> bool:
        return self._restart_factory is not None

    def restart(self) -> None:
        self._eos = False
        self.restarts += 1
        self._restart_factory()

    def position(self) -> int:
        """Absolute sample position of the stream head (produced)."""
        return self._end

    def _pump_until(self, need_end: int) -> None:
        deadline = time.monotonic() + self.timeout_s
        H = len(self._hist)
        while self._end < need_end and not self._eos:
            r, buf = self.fifo.pop(timeout_ms=200)
            if r == 1:
                deadline = time.monotonic() + self.timeout_s
                blk = buf.view(np.float32).reshape(self.block, 2)
                # H is a whole number of blocks and _end advances in
                # whole blocks, so a block never straddles the wrap.
                pos = self._end % H
                self._hist[pos: pos + self.block] = blk
                self._end += self.block
            elif r == -1:
                self._eos = True
            elif time.monotonic() > deadline:
                raise TimeoutError(
                    f"stream stalled: no samples for {self.timeout_s}s "
                    f"(at {self._end}, need {need_end})")

    def read(self, start: int, count: int) -> np.ndarray:
        H = len(self._hist)
        _check_history(count, H, "samples")
        self._pump_until(start + count)
        out = np.zeros((count, 2), np.float32)
        lo = max(start, self._end - H, 0)
        hi = min(start + count, self._end)
        if hi > lo:
            # The ring wraps at most once over a <=H-long window: two
            # contiguous slices instead of a per-sample modulo gather.
            p0 = lo % H
            n1 = min(hi - lo, H - p0)
            out[lo - start: lo - start + n1] = self._hist[p0: p0 + n1]
            if n1 < hi - lo:
                out[lo - start + n1: hi - start] = \
                    self._hist[: hi - lo - n1]
        return out

    def stats(self) -> dict:
        s = dict(self.fifo.stats())
        s["consumed_samples"] = self._end
        return s

    def __len__(self) -> int:
        return 1 << 62


def _format_bytes_per_sample(fmt: str) -> int:
    try:
        return {"i8_iq": 2, "i8": 1, "i16_iq": 4, "c64": 8,
                "gn3s_2bit": 1}[fmt]
    except KeyError:
        raise ValueError(f"unknown format {fmt!r}") from None


def _format_block_bytes(fmt: str, n_samples: int) -> int:
    """Wire bytes for n_samples in a FileSource format (packed_4bit is
    sub-byte: 4 x 4-bit samples per LE u16 word)."""
    if fmt == "packed_4bit":
        if n_samples % 4:
            raise ValueError("packed_4bit needs sample counts % 4 == 0")
        return n_samples // 2
    return n_samples * _format_bytes_per_sample(fmt)


class _NetProducerMixin:
    """Transport-independent half of the network producers: the
    byte-continuous framing loop (residue -> decoded or raw blocks ->
    FIFO) and the lifecycle, shared by the UDP and TCP transports."""

    def _setup(self, fifo, block_samples: int, fmt: str, timeout_s: float,
               raw: bool) -> None:
        import threading

        self.fifo = fifo
        self.block = int(block_samples)
        self.fmt = fmt
        # raw=True: the bytes are an ops.unpack wire format, pushed
        # untouched (PackedStreamSource serves them; the device unpacks).
        # raw=False decodes them to f32 blocks.
        self.raw = raw
        if raw:
            self._blk_bytes = up.wire_bytes(fmt, self.block)
        else:
            self._blk_bytes = _format_block_bytes(fmt, self.block)
        self.timeout_s = timeout_s
        self._stop = False
        self.overruns = 0
        self.thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self.thread.start()
        return self

    def stop(self) -> None:
        self._stop = True
        if self.thread.ident is None:
            # Never started: _run's finally cannot release the
            # resources, so the consumer would hang to its timeout and
            # the bound socket would leak.
            self.fifo.close()
            try:
                self.sock.close()
            except OSError:
                pass

    def _feed(self, residue: bytes, data: bytes) -> bytes:
        """Consume whole blocks from residue+data; returns the new
        residue. The push never waits and counts overruns (a live radio
        must never stall the receive loop)."""
        residue += data
        blk_bytes = self._blk_bytes
        while len(residue) >= blk_bytes:
            if self.raw:
                blk = np.frombuffer(residue[:blk_bytes], np.uint8)
            else:
                blk = decode_samples(
                    residue[:blk_bytes], self.fmt).astype(
                        np.float32).view(np.uint8).reshape(-1)
            residue = residue[blk_bytes:]
            if self.fifo.push(blk, timeout_ms=-1) != 1:
                self.overruns += 1
        return residue


class SocketStreamProducer(_NetProducerMixin):
    """UDP datagram receiver -> sample decode -> ring FIFO.

    The GPS_Source role for a networked front end (the reference reads
    its radios over USB in a dedicated thread, objects/gps_source.cpp:135
    Read). Datagrams carry raw wire-format bytes (any FileSource format,
    or raw=True for ops.unpack packed formats); sample framing is
    byte-continuous across datagrams. Pushes 1 ms blocks without waiting,
    counting overruns.

    Bind with port=0 for an ephemeral port; .port tells the sender where
    to aim. stop() (or a zero-length datagram) ends the stream and closes
    the FIFO.
    """

    def __init__(self, fifo, block_samples: int, fmt: str = "i8_iq",
                 host: str = "127.0.0.1", port: int = 0,
                 timeout_s: float = 10.0, raw: bool = False):
        import socket

        self._setup(fifo, block_samples, fmt, timeout_s, raw)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, port))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]

    def _run(self) -> None:
        import socket

        residue = b""
        deadline = time.monotonic() + self.timeout_s
        try:
            while not self._stop:
                try:
                    data, _ = self.sock.recvfrom(65536)
                except socket.timeout:
                    if time.monotonic() > deadline:
                        break
                    continue
                if not data:          # zero-length datagram = EOS
                    break
                deadline = time.monotonic() + self.timeout_s
                residue = self._feed(residue, data)
        finally:
            self.fifo.close()
            self.sock.close()


class TcpStreamProducer(_NetProducerMixin):
    """TCP byte-stream receiver -> sample decode -> ring FIFO.

    The connection-oriented sibling of SocketStreamProducer: listens on
    host:port (port=0 = ephemeral, .port tells the sender where to aim),
    accepts ONE sender and streams its bytes (any FileSource wire format,
    or raw=True for ops.unpack packed formats pushed untouched). Sample
    framing is byte-continuous; the stream ends when the peer closes
    (FIFO closed -> consumers see end-of-stream).
    """

    def __init__(self, fifo, block_samples: int, fmt: str = "i8_iq",
                 host: str = "127.0.0.1", port: int = 0,
                 timeout_s: float = 10.0, raw: bool = False):
        import socket

        self._setup(fifo, block_samples, fmt, timeout_s, raw)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(1)
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]

    def _run(self) -> None:
        import socket

        conn = None
        deadline = time.monotonic() + self.timeout_s
        try:
            while not self._stop and conn is None:
                try:
                    conn, _ = self.sock.accept()
                except socket.timeout:
                    if time.monotonic() > deadline:
                        return
            if conn is None:
                return
            conn.settimeout(0.2)
            residue = b""
            deadline = time.monotonic() + self.timeout_s
            while not self._stop:
                try:
                    data = conn.recv(65536)
                except socket.timeout:
                    if time.monotonic() > deadline:
                        break
                    continue
                if not data:          # peer closed = end of stream
                    break
                deadline = time.monotonic() + self.timeout_s
                residue = self._feed(residue, data)
        finally:
            if conn is not None:
                conn.close()
            self.fifo.close()
            self.sock.close()


class PackedStreamSource(_PackedReadMixin):
    """Live streaming source that keeps samples in WIRE FORMAT end to
    end: the producer pushes raw packed bytes (1-4 bit formats,
    ops.unpack) into the ring FIFO, the history window stores bytes, and
    the ChannelManager ships them to the device untouched (device-side
    unpack). read() decodes on demand for host consumers (acquisition
    refinement). A 2-bit radio's bytes cross the host exactly once.
    """

    def __init__(self, fifo, block_samples: int, fmt: str = "sm2",
                 history_blocks: int = 1024, timeout_s: float = 10.0):
        self.fifo = fifo
        self.wire_format = fmt
        self._fmt = fmt
        self.block = int(block_samples)
        if self.block % up.align(fmt):
            raise ValueError(f"block_samples must align to {fmt}")
        self._bpb = up.wire_bytes(fmt, self.block)   # bytes per block
        self._spb = up.samples_per_byte(fmt)
        self.hist_blocks = int(history_blocks)
        self.timeout_s = timeout_s
        self._hist = np.zeros(self.hist_blocks * self._bpb, np.uint8)
        self._end = 0            # absolute SAMPLES consumed from the FIFO
        self._eos = False
        self._restart_factory = None
        self.restarts = 0

    set_restart = StreamSource.set_restart
    can_restart = StreamSource.can_restart
    restart = StreamSource.restart
    position = StreamSource.position
    stats = StreamSource.stats

    def _pump_until(self, need_end_samples: int) -> None:
        deadline = time.monotonic() + self.timeout_s
        H = len(self._hist)
        while self._end < need_end_samples and not self._eos:
            r, buf = self.fifo.pop(timeout_ms=200)
            if r == 1:
                deadline = time.monotonic() + self.timeout_s
                # H is a whole number of byte-blocks and _end advances
                # in whole blocks: a block never straddles the wrap.
                pos = int(self._end / self._spb) % H
                self._hist[pos: pos + self._bpb] = buf
                self._end += self.block
            elif r == -1:
                self._eos = True
            elif time.monotonic() > deadline:
                raise TimeoutError(
                    f"stream stalled: no samples for {self.timeout_s}s "
                    f"(at {self._end}, need {need_end_samples})")

    def read_packed(self, start: int, count: int) -> np.ndarray:
        a = up.align(self._fmt)
        if start % a or count % a:
            raise ValueError(f"unaligned packed read ({start}, {count})")
        H = len(self._hist)
        _check_history(count, int(H * self._spb), "samples")
        self._pump_until(start + count)
        out = np.zeros(int(count / self._spb), np.uint8)
        lo = max(start, self._end - int(H * self._spb), 0)
        hi = min(start + count, self._end)
        if hi > lo:
            b0 = int(lo / self._spb)
            b1 = int(hi / self._spb)
            o0 = b0 - int(start / self._spb)
            p0 = b0 % H
            n1 = min(b1 - b0, H - p0)
            out[o0: o0 + n1] = self._hist[p0: p0 + n1]
            if n1 < b1 - b0:
                out[o0 + n1: o0 + (b1 - b0)] = \
                    self._hist[: b1 - b0 - n1]
        return out

    def ended_at(self, pos: int) -> bool:
        """True once the producer closed the FIFO and `pos` is past the
        last produced sample (packed bytes have no zero-fill sentinel)."""
        return self._eos and pos >= self._end

    def __len__(self) -> int:
        return 1 << 62


class FileStreamProducer:
    """Producer thread: file reader + sample-format decode feeding a
    RingFifo with 1 ms f32 blocks (the GPS_Source read thread,
    objects/gps_source.cpp:135).

    realtime_fs throttles production to the given sample rate (a live
    radio's pace); 0 streams as fast as the file reads.

    fs_in/fs_out arm decimate-on-ingest (the reference's Resample_USRP_V1
    role, objects/gps_source.cpp:436,566): the thread resamples each
    block to the receiver's rate before pushing it, on `device` ('cuda'
    by default, on a CUDA stream of its own; see ops.resample).
    """

    #: Blocks per source read (one resampler call per batch).
    READ_BLOCKS = 32

    def __init__(self, path: str, fifo, block_samples: int,
                 fmt: str = "i8_iq", realtime_fs: float = 0.0,
                 skip_samples: int = 0, fs_in: float = 0.0,
                 fs_out: float = 0.0, resample_mode: str = "polyphase", *,
                 device="cuda"):
        import threading

        self.src = FileSource(path, fmt=fmt, skip_samples=skip_samples)
        if fs_in and fs_out and fs_in != fs_out:
            from gnsstpu_torch.ops.resample import ResampledSource
            self.src = ResampledSource(self.src, fs_in, fs_out,
                                       mode=resample_mode, device=device)
        self.fifo = fifo
        self.block = int(block_samples)
        self.realtime_fs = realtime_fs
        self._stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "FileStreamProducer":
        self.thread.start()
        return self

    def stop(self) -> None:
        self._stop = True
        if self.thread.ident is None:
            self.fifo.close()      # never started: close here

    def _run(self) -> None:
        pos = 0
        n = len(self.src)
        t0 = time.monotonic()
        run = []                  # blocks read ahead, not pushed yet
        while not self._stop and pos < n:
            if not run:
                # READ_BLOCKS blocks per source read: one resampler call
                # (and one file read) per batch instead of per block. The
                # blocks are the ones per-block reads give: every output
                # sample's sum is independent of the batch.
                k = min(self.READ_BLOCKS, -(-(n - pos) // self.block))
                batch = self.src.read(pos, k * self.block)
                run = list(batch.astype(np.float32).reshape(
                    k, self.block * 2))[::-1]
            wire = run.pop().view(np.uint8)
            # Blocking push, retried for as long as it takes: file replay
            # is lossless, so a consumer stall longer than one push
            # timeout must not truncate the stream. stop() still
            # interrupts between attempts; -1 (FIFO closed by the
            # consumer) is permanent and ends the thread.
            pushed = False
            while not self._stop:
                rc = self.fifo.push(wire, timeout_ms=1000)
                if rc == 1:
                    pushed = True
                    break
                if rc == -1:
                    break
            if not pushed:
                break
            pos += self.block
            if self.realtime_fs > 0:
                dt = t0 + pos / self.realtime_fs - time.monotonic()
                if dt > 0:
                    time.sleep(dt)
        self.fifo.close()
