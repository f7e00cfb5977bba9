"""The port's host library: the blocking ring FIFO of fixed-size blocks
between a live producer thread and the receiver (port of the ring FIFO
of gnsstpu/native/__init__.py).

The C++ source, csrc/host/ring_fifo.cpp, is the reference's
native/src/ring_fifo.cpp byte for byte, so the overrun, timeout and close
semantics that the stream producers and the manager's watchdog rely on
are the reference's own code. It is compiled at first use with the host
compiler (g++, which nvcc needs too) into `build/native/` at the root of
the checkout, under a name that carries a hash of the source and the
flags, and bound with ctypes. Nothing here runs at import time.

There is no Python fallback, as in the reference: without a compiler,
RingFifo raises RuntimeError naming it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / \
    "ring_fifo.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(
            f"host C++ compiler {cxx!r} not found (set CXX or put g++ on "
            "PATH): the ring FIFO is built from csrc/host/ring_fifo.cpp at "
            "first use")
    return found


def _target() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libring_fifo_{digest}.so"


def _load() -> ctypes.CDLL:
    """Build (if not built yet) and bind the FIFO library; raises
    RuntimeError when it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = _target()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {SOURCE.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        i64, i32, p = ctypes.c_int64, ctypes.c_int32, ctypes.POINTER
        lib.fifo_create.restype = ctypes.c_void_p
        lib.fifo_create.argtypes = [i64, i64]
        lib.fifo_destroy.restype = None
        lib.fifo_destroy.argtypes = [ctypes.c_void_p]
        lib.fifo_close.restype = None
        lib.fifo_close.argtypes = [ctypes.c_void_p]
        lib.fifo_push.restype = i32
        lib.fifo_push.argtypes = [ctypes.c_void_p, p(ctypes.c_uint8)]
        lib.fifo_push_wait.restype = i32
        lib.fifo_push_wait.argtypes = [ctypes.c_void_p, p(ctypes.c_uint8),
                                       i64]
        lib.fifo_pop.restype = i32
        lib.fifo_pop.argtypes = [ctypes.c_void_p, p(ctypes.c_uint8), i64]
        lib.fifo_stats.restype = None
        lib.fifo_stats.argtypes = [ctypes.c_void_p, p(i64)]
        _lib = lib
        return lib


def available() -> bool:
    """True when the FIFO library is built or can be built here."""
    try:
        _load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


class RingFifo:
    """Blocking ring of `depth` fixed-size byte blocks (the reference's
    objects/fifo.cpp:53-187 role). push(block) without a timeout never
    waits: a full ring drops the block and counts an overrun (returns 0);
    push(block, timeout_ms>=0) waits for room (1 pushed, 0 timed out, -1
    closed). pop(timeout_ms) returns (1, block), (0, _) on timeout and
    (-1, _) once closed and drained."""

    def __init__(self, depth: int, block_bytes: int):
        if depth < 1 or block_bytes < 1:
            raise ValueError(f"RingFifo({depth}, {block_bytes})")
        self._lib = _load()
        self._h = self._lib.fifo_create(depth, block_bytes)
        self.block_bytes = block_bytes

    def push(self, block: np.ndarray, timeout_ms: int = -1) -> int:
        buf = np.ascontiguousarray(block, np.uint8)
        if buf.nbytes != self.block_bytes:
            raise ValueError(f"block of {buf.nbytes} bytes, the FIFO's "
                             f"blocks have {self.block_bytes}")
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        if timeout_ms < 0:
            return self._lib.fifo_push(self._h, ptr)
        return self._lib.fifo_push_wait(self._h, ptr, timeout_ms)

    def pop(self, timeout_ms: int = 1000):
        out = np.empty(self.block_bytes, np.uint8)
        r = self._lib.fifo_pop(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            timeout_ms)
        return r, out

    def stats(self) -> dict:
        s = np.zeros(4, np.int64)
        self._lib.fifo_stats(
            self._h, s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return {"count": int(s[0]), "pushed": int(s[1]),
                "popped": int(s[2]), "overruns": int(s[3])}

    def close(self) -> None:
        self._lib.fifo_close(self._h)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h is not None:
            self._lib.fifo_destroy(h)
            self._h = None
