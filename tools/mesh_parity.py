"""Sharded against unsharded ChannelManager, traced epoch step by step.

tests/test_torch_parallel.py holds a ChannelManager on a channel=2 mesh
bit-exact against the unsharded manager, at the configuration of the
reference's tests/test_parallel.py::_mgr_parity_run (3 SVs at 47 dB-Hz,
2.048 Msps, 4 channels, 100 ms epochs, prefetch). This tool repeats that
comparison many times on the CPU, with as many torch threads as asked,
and records every epoch step's inputs and outputs (the state gathered
along C) and every slot allocation of both runs. For each repeat it
prints the first point where the two runs part:

  * "alloc": a slot was given another PRN, code phase or Doppler (the
    search or the supervision differed before the step);
  * "inputs": an epoch step began from other windows or state;
  * "outputs": one step on equal inputs gave other results, with the
    indices of the leaves that differ (a tracker op whose result depends
    on the batch size or the thread count).

    python3 tools/mesh_parity.py [--repeats 40] [--threads 8]
        [--engine gather] [--ms 600]

It imports the port only; the signal is the test's sky and seed through
the port's simulator (noise="jax"), not the test's samples, which come
from the reference's simulator. It prints one line per repeat and a
summary line "parted N of M".
"""

from __future__ import annotations

import argparse
import io
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gnsstpu_torch.config import (AcqConfig, ReceiverConfig,  # noqa: E402
                                  SignalConfig, TrackConfig)
from gnsstpu_torch.parallel import make_mesh  # noqa: E402
from gnsstpu_torch.parallel.mesh import (Replicated, Sharded,  # noqa: E402
                                         tree_leaves)
from gnsstpu_torch.runtime.manager import ChannelManager  # noqa: E402
from gnsstpu_torch.runtime.sources import ArraySource  # noqa: E402
from gnsstpu_torch.runtime.telemetry import Telemetry  # noqa: E402
from gnsstpu_torch.sim import IFSimulator, SatParams  # noqa: E402

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)


def config() -> ReceiverConfig:
    return ReceiverConfig(
        signal=SIG,
        acq=AcqConfig(doppler_band=4e3, coherent_ms=2, threshold=2.4,
                      prn_list=(2, 5, 9), fine_doppler_ms=10),
        track=TrackConfig(dll_bw=1.0, el_spacing=0.3), n_channels=4)


def signal() -> np.ndarray:
    sats = [SatParams(prn=p, doppler_hz=300.0 * (p - 5),
                      code_phase_chips=211.5 * p, cn0_dbhz=47.0)
            for p in (2, 5, 9)]
    return np.asarray(IFSimulator(SIG, sats, noise_sigma=1.0, seed=13,
                                  device="cpu", noise="jax").generate(660))


def whole(x):
    """A step argument as one value: Sharded gathered, Replicated's copy,
    a bank dict leafwise."""
    if isinstance(x, Sharded):
        return x.gather()
    if isinstance(x, Replicated):
        return next(iter(x.values()))
    if isinstance(x, dict):
        return {k: whole(v) for k, v in sorted(x.items())}
    return x


def traced_run(samples, engine: str, n_ms: int, mesh) -> list:
    """One manager run; its log of ("alloc", args) and ("step", inputs,
    outputs) events in order."""
    log: list = []
    mgr = ChannelManager(
        ArraySource(samples), config(), device="cpu",
        telemetry=Telemetry(sink=io.StringIO()), epoch_ms=100,
        reacq_period_ms=400, cn0_drop_dbhz=35.0, prn_pool=[2, 5, 9, 17],
        sync_every=2, prefetch=True, engine=engine, mesh=mesh)
    step, alloc = mgr._step_epoch, mgr._alloc

    def traced_step(win, bank, state):
        ins = [t.clone() for t in tree_leaves((whole(win), whole(state)))]
        st, obs = step(win, bank, state)
        outs = [t.clone() for t in tree_leaves((whole(st), obs))
                if t is not None]
        log.append(("step", ins, outs))
        return st, obs

    def traced_alloc(*args, **kw):
        log.append(("alloc", args, kw))
        return alloc(*args, **kw)

    mgr._step_epoch, mgr._alloc = traced_step, traced_alloc
    mgr.run(n_ms)
    return log


def first_parting(a: list, b: list):
    """(event index, kind, detail) where two logs first differ, or
    None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x[0] != y[0]:
            return i, "event", (x[0], y[0])
        if x[0] == "alloc":
            if x[1:] != y[1:]:
                return i, "alloc", (x[1:], y[1:])
            continue
        for part, (p, q) in (("inputs", (x[1], y[1])),
                             ("outputs", (x[2], y[2]))):
            bad = [j for j, (s, t) in enumerate(zip(p, q))
                   if not torch.equal(s, t)]
            if bad or len(p) != len(q):
                return i, part, bad
    if len(a) != len(b):
        return min(len(a), len(b)), "length", (len(a), len(b))
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=40)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--engine", default="gather")
    ap.add_argument("--ms", type=int, default=600)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    samples = signal()
    parted = 0
    for r in range(args.repeats):
        one = traced_run(samples, args.engine, args.ms, None)
        two = traced_run(samples, args.engine, args.ms,
                         make_mesh([("channel", 2)], devices=["cpu"] * 2))
        where = first_parting(one, two)
        parted += where is not None
        print(f"repeat {r}: {len(one)} events, "
              f"{'equal' if where is None else f'parted at {where}'}",
              flush=True)
    print(f"parted {parted} of {args.repeats} (threads {args.threads}, "
          f"engine {args.engine})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
