"""Build the port's CUDA sources into shared libraries and load them.

Each kernel source in gnsstpu_torch/csrc/ has a plain C interface and is
compiled with nvcc for Hopper (sm_90a) into `build/kernels/` at the root
of the checkout, at first use, then loaded with ctypes; load_many()
starts one nvcc per source, all together. The library name
carries a hash of the source and of the shared headers (csrc/*.cuh), so
an edited kernel never loads a stale build. Nothing here runs at import time: this module is imported on
machines without nvcc or a GPU.

Flags: -O3, no --use_fast_math (it changes the division and sinf/cosf the
tracking kernel's bookkeeping depends on), -fmad=false (no contraction
of a*b+c, so the kernel rounds like its plain PyTorch twin).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


class BuiltLibrary:
    """A loaded kernel library with its build record."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.build_s = seconds      # 0.0 when an existing build was loaded
        self.log = log              # nvcc / ptxas output of the build


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
            "port's CUDA kernels are built from source at first use")
    return found


def _target(source: str) -> Path:
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def load(source: str) -> BuiltLibrary:
    """Compile csrc/<source> (if not built yet) and load it."""
    return load_many([source])[0]


def load_many(sources) -> list:
    """Compile every csrc/<source> not built yet, one nvcc process per
    source, all started together, then load them all. Returns their
    BuiltLibrary records in the order given."""
    with _lock:
        todo = [s for s in dict.fromkeys(sources) if s not in _libs]
        procs = {}
        for source in todo:
            out = _target(source)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[source] = (time.perf_counter(), tmp, subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        records = {}
        try:
            for source, (t0, tmp, proc) in procs.items():
                log = proc.communicate(timeout=600)[0]
                records[source] = (time.perf_counter() - t0, log)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {source}:\n{log}")
                os.replace(tmp, _target(source))
        finally:
            for _, _, proc in procs.values():     # none left running
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        for source in todo:
            out = _target(source)
            seconds, log = records.get(source, (0.0, ""))
            _libs[source] = BuiltLibrary(ctypes.CDLL(str(out)), out,
                                         seconds, log)
        return [_libs[s] for s in sources]
