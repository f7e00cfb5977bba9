"""Remote station transport: telemetry + commands over a TCP socket.

The reference splits its telemetry between a local named pipe to the GUI
(/tmp/GPS2GUI, objects/telemetry.cpp:80-89) and a serial port for a
remote monitor (/dev/ttyS0 path, objects/telemetry.cpp:193), with the
command backhaul on the reverse pipe (/tmp/GUI2GPS, commando.cpp). The
TPU framework's equivalent transport is a TCP socket: ``StationServer``
runs next to the receiver, fans the JSONL telemetry bus out to any
number of connected stations, and feeds command lines received from
them into a ``CommandBus``-compatible queue the ChannelManager polls.
``GroundStation`` (runtime.station) connects with a ``tcp://host:port``
URL instead of a log-file path — the operator console can monitor and
command a receiver on another host.

Wire format: newline-delimited JSON in both directions (exactly the
JSONL telemetry records downstream, exactly the CommandBus command
objects upstream) — one protocol for file, pipe, and socket.

Copied from gnsstpu/runtime/remote.py; only the import prefix differs.
"""

from __future__ import annotations

import json
import queue
import socket
import threading
from typing import List, Optional


class _QueueCommands:
    """CommandBus-compatible view of commands received over the wire."""

    def __init__(self) -> None:
        self._q: "queue.Queue[dict]" = queue.Queue()

    def push(self, cmd: dict) -> None:
        self._q.put(cmd)

    def poll(self) -> List[dict]:
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out


class _Client:
    """One connected station: a bounded outbound queue drained by a
    writer thread, so the receiver's telemetry emit NEVER blocks on a
    slow peer — records to a backed-up station are dropped, counted,
    and the stream continues (the reference's non-blocking GUI pipe
    drops writes the same way, telemetry.cpp)."""

    def __init__(self, sock: socket.socket, max_queue: int = 4096):
        self.sock = sock
        self.q: "queue.Queue[Optional[bytes]]" = queue.Queue(max_queue)
        self.dropped = 0
        self.dead = False
        self._writer = threading.Thread(target=self._write_loop,
                                        daemon=True)
        self._writer.start()

    def offer(self, data: bytes) -> None:
        try:
            self.q.put_nowait(data)
        except queue.Full:
            self.dropped += 1

    def _write_loop(self) -> None:
        while True:
            data = self.q.get()
            if data is None or self.dead:
                break
            try:
                self.sock.sendall(data)
            except OSError:
                break
        self.dead = True
        try:
            self.sock.close()
        except OSError:
            pass

    def close(self) -> None:
        self.dead = True
        try:
            self.q.put_nowait(None)    # wake the writer
        except queue.Full:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class StationServer:
    """TCP fan-out of a receiver's telemetry + command backhaul.

    Usage (receiver side)::

        srv = StationServer()                    # OS-assigned port
        srv.attach(telemetry)                    # subscribe to the bus
        mgr = ChannelManager(..., commands=srv.commands)
        ...
        srv.close()

    Emission never blocks the receiver loop: each client has a bounded
    outbound queue drained by its own writer thread; a slow or stalled
    station loses records (counted per client) and a dead one is
    dropped (the reference likewise drops GUI writes when the pipe
    backs up, telemetry.cpp non-blocking open).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 send_timeout_s: float = 0.5):
        self.commands = _QueueCommands()
        self._send_timeout = send_timeout_s
        self._lock = threading.Lock()
        self._clients: List[_Client] = []
        self._closed = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self.host, self.port = self._srv.getsockname()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    # -- wiring --

    def attach(self, telemetry) -> None:
        """Subscribe to a Telemetry bus: every record fans out live."""
        telemetry.subscribe(self.send)

    def send(self, rec: dict) -> None:
        """Enqueue one telemetry record to every connected station
        (non-blocking; see _Client)."""
        data = (json.dumps(rec) + "\n").encode()
        dead = []
        with self._lock:
            clients = list(self._clients)
        for c in clients:
            if c.dead:
                dead.append(c)
            else:
                c.offer(data)
        for c in dead:
            self._drop(c)

    def _drop(self, c: _Client) -> None:
        with self._lock:
            if c in self._clients:
                self._clients.remove(c)
        c.close()

    # -- server loops --

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _addr = self._srv.accept()
            except OSError:
                return
            sock.settimeout(self._send_timeout)
            c = _Client(sock)
            with self._lock:
                self._clients.append(c)
            threading.Thread(target=self._client_reader, args=(c,),
                             daemon=True).start()

    def _client_reader(self, c: _Client) -> None:
        """Drain newline-delimited command JSON from one station."""
        buf = b""
        while not self._closed and not c.dead:
            try:
                chunk = c.sock.recv(4096)
            except socket.timeout:
                continue
            except OSError:
                break
            if not chunk:
                break
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                line = line.strip()
                if not line:
                    continue
                try:
                    self.commands.push(json.loads(line.decode()))
                except (json.JSONDecodeError, UnicodeDecodeError):
                    pass
        self._drop(c)

    def n_clients(self) -> int:
        with self._lock:
            return sum(1 for c in self._clients if not c.dead)

    def close(self) -> None:
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            clients = list(self._clients)
            self._clients.clear()
        for c in clients:
            c.close()


def parse_tcp_url(url: str) -> Optional[tuple]:
    """'tcp://host:port' -> (host, port); None for plain paths."""
    if not url.startswith("tcp://"):
        return None
    hostport = url[len("tcp://"):]
    host, _, port = hostport.rpartition(":")
    if not port.isdigit():
        raise ValueError(
            f"station URL {url!r} needs an explicit port: "
            "tcp://HOST:PORT")
    return (host or "127.0.0.1", int(port))


class StationSocket:
    """Client side of the station link: line-buffered reads of
    telemetry + command writes, over one TCP connection. ``closed``
    turns True on peer EOF/error so the owner can reconnect."""

    def __init__(self, host: str, port: int, timeout_s: float = 5.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)
        self._sock.setblocking(False)
        self._buf = b""
        self.closed = False

    def read_lines(self) -> List[str]:
        """All complete telemetry lines currently available (non-
        blocking)."""
        while True:
            try:
                chunk = self._sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self.closed = True
                break
            if not chunk:
                self.closed = True     # peer EOF
                break
            self._buf += chunk
        lines = []
        while b"\n" in self._buf:
            line, self._buf = self._buf.split(b"\n", 1)
            if line.strip():
                lines.append(line.decode(errors="replace"))
        return lines

    def send_command(self, cmd: dict) -> None:
        self._sock.setblocking(True)
        try:
            self._sock.sendall((json.dumps(cmd) + "\n").encode())
        finally:
            self._sock.setblocking(False)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
