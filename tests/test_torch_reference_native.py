"""torch_port.reference_native, the port tests' way to the reference's
native library (gnsstpu.native), on the CPU.

The reference links native/libgnsstpu_native.so straight onto its path
with `make` at first use and remembers a failed load for the life of the
process. On a fresh checkout the pytest-xdist workers all run that build
at once while they collect the reference's tests, and a worker that met
a half-written file would fail every port test that holds the port
against the reference's ring FIFO, golden model or codecs. Here: a worker
that kept such a failure recovers; six processes that race the build on
a copy of native/ each get a loaded library from the helper afterwards;
and a build that cannot succeed fails the test with the compiler's
output, never a skip or the NumPy fallbacks.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from gnsstpu import native
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import reference_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROC = 6
WAIT_S = 120.0


def _native_copy(root) -> str:
    """native/'s Makefile and sources under `root`, with no library."""
    d = os.path.join(str(root), "native")
    os.makedirs(d)
    shutil.copy(os.path.join(REPO, "native", "Makefile"), d)
    shutil.copytree(os.path.join(REPO, "native", "src"),
                    os.path.join(d, "src"))
    return d


def test_worker_that_lost_the_race_recovers(monkeypatch):
    """The memo of a worker whose load failed (`_lib` None, `_tried`
    True): available() stays False, and the helper loads the library."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.available()
    mod = reference_native()
    assert mod is native and native.available()
    f = mod.RingFifo(3, 8)
    assert f.push(np.arange(8, dtype=np.uint8)) == 1
    r, b = f.pop(timeout_ms=1000)
    assert r == 1 and b.tolist() == list(range(8))
    f.close()


#: One racing process: points gnsstpu.native at the copy, waits for the
#: start, asks available() as the reference's tests do at collection,
#: then, once every process has asked, loads through the helper.
RACER = textwrap.dedent("""
    import json, os, sys, time
    import numpy as np
    sys.path.insert(0, {tests!r})
    from gnsstpu import native
    from torch_port import reference_native

    d, sync, i = {native_dir!r}, {sync!r}, int(sys.argv[1])
    native._NATIVE_DIR = d
    native._LIB_PATH = os.path.join(d, "libgnsstpu_native.so")

    def wait_for(name):
        t = time.monotonic() + {wait_s!r}
        while not os.path.exists(os.path.join(sync, name)):
            if time.monotonic() > t:
                sys.exit(f"no {{name}} signal")
            time.sleep(0.002)

    def signal(name):
        open(os.path.join(sync, f"{{name}}{{i}}"), "w").close()

    signal("ready")
    wait_for("go")
    first = native.available()
    signal("asked")
    wait_for("helper")
    mod = reference_native()
    f = mod.RingFifo(3, 8)
    pushed = f.push(np.arange(8, dtype=np.uint8))
    r, b = f.pop(timeout_ms=1000)
    print(json.dumps({{"first": first, "loaded": native._lib._name,
                      "round_trip": [pushed, r, b.tolist()]}}))
""")


def _wait_all(sync: str, name: str, procs) -> None:
    t = time.monotonic() + WAIT_S
    while not all(os.path.exists(os.path.join(sync, f"{name}{i}"))
                  for i in range(N_PROC)):
        dead = [p.returncode for p in procs if p.poll() is not None]
        assert not dead, f"a racer exited before '{name}': {dead}"
        assert time.monotonic() < t, f"no '{name}' from every racer"
        time.sleep(0.01)


def test_fresh_tree_race_then_helper_loads(tmp_path):
    """The fresh-tree race, reproduced: six processes start together on a
    copy of native/ with no library and each calls available() (some
    may lose; the race is not certain, so nothing is asserted of it).
    Then, in each of the six, the helper returns the copy's library
    loaded, and its ring FIFO pushes and pops."""
    d = _native_copy(tmp_path)
    sync = tmp_path / "sync"
    sync.mkdir()
    script = RACER.format(tests=os.path.join(REPO, "tests"),
                          native_dir=d, sync=str(sync), wait_s=WAIT_S)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for i in range(N_PROC)]
    try:
        _wait_all(str(sync), "ready", procs)
        (sync / "go").touch()
        _wait_all(str(sync), "asked", procs)
        (sync / "helper").touch()
        outs = [p.communicate(timeout=WAIT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lib = os.path.join(d, "libgnsstpu_native.so")
    firsts = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        res = json.loads(out.strip().splitlines()[-1])
        firsts.append(res["first"])
        assert res["loaded"] == lib
        assert res["round_trip"] == [1, 1, list(range(8))]
    print(f"available() before the helper: {firsts}")
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_broken_build_fails_with_the_compiler_output(tmp_path, monkeypatch):
    """A copy whose source does not compile: the helper fails the test,
    and the failure carries the compiler's error. No library is loaded,
    none is left behind, and nothing falls back to NumPy."""
    d = _native_copy(tmp_path)
    src = os.path.join(d, "src", "ring_fifo.cpp")
    with open(src) as f:
        text = f.read()
    with open(src, "w") as f:
        f.write("#error reference_native must fail loudly\n" + text)
    monkeypatch.setattr(native, "_NATIVE_DIR", d)
    monkeypatch.setattr(native, "_LIB_PATH",
                        os.path.join(d, "libgnsstpu_native.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    with pytest.raises(BaseException) as failed:   # a skip is one too
        reference_native()
    assert failed.type is pytest.fail.Exception, repr(failed.value)
    msg = str(failed.value)
    assert "`make` exited" in msg
    assert "#error reference_native must fail loudly" in msg
    assert "ring_fifo.cpp" in msg
    assert native._lib is None
    assert sorted(os.listdir(d)) == ["Makefile", "src"]
