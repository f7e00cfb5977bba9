"""Two-process smoke of the port's distributed mesh: two localhost
torch.distributed (gloo) processes run parallel.timeblock's long
coherent acquisition across the process boundary, with
tests/test_dcn.py's sky and checks (the reference's runs
jax.distributed)."""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_long_coherent():
    worker = os.path.join(os.path.dirname(__file__), "torch_dcn_worker.py")
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, "2", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(worker))))
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("worker timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"RESULT {i} prn_row=1 dopp_bin=1" in out, out
        assert f"OK {i}" in out, out
