"""Helpers shared by the port's tests (tests/test_torch_*.py)."""

import ctypes
import dataclasses
import fcntl
import importlib
import os
import subprocess

import numpy as np
import pytest
import torch


def to_port(obj):
    """The port's counterpart of a gnsstpu dataclass instance (a config,
    an ephemeris): the class of the same name in the same module of
    gnsstpu_torch, built with the same field values, nested dataclasses
    included. Each package is then handed objects of its own classes."""
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        return obj
    mod = type(obj).__module__
    if mod.split(".")[0] != "gnsstpu":
        raise TypeError(f"{type(obj)} is not a gnsstpu class")
    cls = getattr(importlib.import_module("gnsstpu_torch" + mod[7:]),
                  type(obj).__name__)
    return cls(**{f.name: to_port(getattr(obj, f.name))
                  for f in dataclasses.fields(obj) if f.init})


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_per_worker():
    """Under pytest-xdist, torch runs one intra-op thread per worker: the
    workers already fill the host's cores, and a thread pool per worker on
    top of them oversubscribes it (a port test that takes seconds alone
    took minutes in a six-worker run). A single-process run keeps torch's
    default. Test modules import this fixture to turn it on."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def reference_native():
    """gnsstpu.native with the reference's library loaded, or a failed
    test: never a skip, never its NumPy fallbacks.

    The reference builds native/libgnsstpu_native.so with `make` at first
    use, linking straight onto that path, and remembers a failed load for
    the life of the process. Under pytest-xdist every worker imports the
    reference's tests, three of which ask for the library at collection,
    so on a fresh checkout the workers run that `make` at once, and a
    worker that met a half-written file keeps its failure. Every such
    build has ended before the first test runs, so this clears the memo
    and loads again. If the file still does not load, it builds it once
    more under a lock that the processes share (build/ beside native/),
    to a temporary name that then replaces the library, and loads that.
    The paths come from the module, so a test can point it at a copy."""
    from gnsstpu import native

    if native.available():
        return native
    lock_dir = os.path.join(os.path.dirname(native._NATIVE_DIR), "build")
    os.makedirs(lock_dir, exist_ok=True)
    with open(os.path.join(lock_dir, "reference_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(native._LIB_PATH) and _load_again(native):
            return native
        tmp = f"{native._LIB_PATH}.{os.getpid()}.tmp"
        try:
            run = subprocess.run(
                ["make", "-C", native._NATIVE_DIR, f"OUT={tmp}"],
                capture_output=True, text=True, timeout=300)
            if run.returncode == 0:
                os.replace(tmp, native._LIB_PATH)
                if _load_again(native):
                    return native
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    why = f"`make` exited {run.returncode}"
    if run.returncode == 0:
        try:
            ctypes.CDLL(native._LIB_PATH)
            why = "built, but gnsstpu.native still does not load it"
        except OSError as e:
            why = f"built, but it does not load: {e}"
    pytest.fail(f"the reference's native library {native._LIB_PATH}: "
                f"{why}\n--- make's stdout\n{run.stdout}"
                f"--- make's stderr\n{run.stderr}", pytrace=False)


def _load_again(native) -> bool:
    """Clear gnsstpu.native's memo of its load and load the library."""
    with native._lock:
        native._lib, native._tried = None, False
    return native.available()


@pytest.fixture(autouse=True, scope="module")
def reference_native_library():
    """Test modules that run the reference's native library (its ring
    FIFO, golden model or codecs) beside the port's import this fixture:
    it loads that library before the module's first test, or fails."""
    return reference_native()


def nav_record(sig, sats, n_ms, seed):
    """(i_p, abs_sample, carr_freq), each [C, n_ms], of a tracker that
    followed gnsstpu SatParams `sats` perfectly: code period m of channel
    c ends at abs_sample[c, m] under the simulator's code-phase model
    (gnsstpu/sim/generator.py: chips(t) = f_code t (1 + (fd + rate t / 2)
    / f_carr) - code_phase_chips, f_carr the satellite's own carrier, an
    FDMA channel's included), and its prompt is its nav symbol with
    seeded noise; past the last symbol it holds the last one, as the
    simulator does."""
    from gnsstpu.signals.registry import get_signal

    sd = get_signal(sig.signal)
    rng = np.random.default_rng(seed)
    m = np.arange(1, n_ms + 1, dtype=np.float64)
    i_p, abs_s, carr = [], [], []
    for s in sats:
        f_carr = sd.carrier_freq(s.prn)
        a = sig.code_freq * 0.5 * s.doppler_rate / f_carr
        b = sig.code_freq * (1.0 + s.doppler_hz / f_carr)
        c = m * sig.code_length + s.code_phase_chips
        t_end = 2.0 * c / (b + np.sqrt(b * b + 4.0 * a * c))
        abs_s.append(t_end * sig.fs)
        t_start = np.concatenate([[t_end[0] - 1e-3], t_end[:-1]])
        carr.append(sig.if_freq + s.if_offset_hz + s.doppler_hz
                    + s.doppler_rate * t_start)
        nav = np.asarray(s.nav_bits)
        idx = (m.astype(np.int64) - 1) // sd.bit_len_codes
        bits = nav[np.minimum(idx, len(nav) - 1)]
        i_p.append(600.0 * bits + rng.normal(0.0, 40.0, n_ms))
    return (np.array(i_p, np.float32), np.array(abs_s),
            np.array(carr))
