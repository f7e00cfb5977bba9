"""Multi-card receiver demo on the PyTorch + CUDA port: the SAME live
ChannelManager, sharded.

examples/e2e_multichip.py on gnsstpu_torch, with its scenario, seed,
constants and printed steps: a device mesh with a "channel" axis is
built, the slot bank and carried tracking state split over it
(parallel.mesh.Sharded, one part per shard on its shard's device), the
sample chunk is replicated, and the pipelined receiver run (acquisition
handoff, superepochs, on-chunk reacquisition, supervision) launches its
tracker once per shard, each on its own CUDA stream: kernel K1 (the
fused engine; its plain twin on the CPU). The script imports torch,
numpy and gnsstpu_torch only.

The mesh takes one card per shard. With fewer cards the shards share
them round-robin, and make_mesh says so with a RuntimeWarning; there is
no fallback to CPU devices (the reference falls back to virtual CPU
devices). --device cpu builds the mesh on the CPU, every shard there.
The reference checks that the state's JAX sharding has a mesh; the port
checks that the manager's state is a Sharded on this mesh, one part on
each shard's device.

Run: python examples/torch_e2e_multichip.py [n_devices] [--device cuda|cpu]

The device is the card unless --device says otherwise; without a card
the script raises. main(device, n_dev) returns a dict of what it
checked.
"""

import argparse
import io
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from gnsstpu_torch.config import (AcqConfig, ReceiverConfig,  # noqa: E402
                                  SignalConfig, TrackConfig)
from gnsstpu_torch.device import resolve_device  # noqa: E402
from gnsstpu_torch.parallel import make_mesh  # noqa: E402
from gnsstpu_torch.parallel.mesh import Sharded  # noqa: E402
from gnsstpu_torch.runtime.manager import ChannelManager  # noqa: E402
from gnsstpu_torch.runtime.sources import ArraySource  # noqa: E402
from gnsstpu_torch.runtime.telemetry import Telemetry  # noqa: E402
from gnsstpu_torch.sim import IFSimulator, SatParams  # noqa: E402

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
PRNS = (2, 5, 9)
SEED = 13
RUN_MS = 600


def sky() -> list:
    """The three SVs: Doppler 300 Hz x (PRN - 5), code phase 211.5 chips
    x PRN, 47 dB-Hz."""
    return [SatParams(prn=p, doppler_hz=300.0 * (p - 5),
                      code_phase_chips=211.5 * p, cn0_dbhz=47.0)
            for p in PRNS]


def config(n_dev: int) -> ReceiverConfig:
    """Two slots per shard over the three PRNs, 10 ms fine-Doppler
    handoff."""
    return ReceiverConfig(
        signal=SIG,
        acq=AcqConfig(doppler_band=4e3, coherent_ms=2, threshold=2.4,
                      prn_list=PRNS, fine_doppler_ms=10),
        track=TrackConfig(dll_bw=1.0, el_spacing=0.3),
        n_channels=2 * n_dev)


def main(device="cuda", n_dev: int = 2) -> dict:
    dev = resolve_device(device)
    mesh = make_mesh([("channel", n_dev)],
                     devices=[dev] * n_dev if dev.type == "cpu" else None)
    print(f"mesh: {mesh}")

    sim = IFSimulator(SIG, sky(), noise_sigma=1.0, seed=SEED, device=dev,
                      noise="jax")
    samples = np.asarray(sim.generate(RUN_MS + 60))

    mgr = ChannelManager(
        ArraySource(samples), config(n_dev), device=dev,
        telemetry=Telemetry(sink=io.StringIO()), epoch_ms=100,
        reacq_period_ms=400, prn_pool=list(PRNS), sync_every=2,
        prefetch=True, mesh=mesh)

    t0 = time.perf_counter()
    recs = mgr.run(RUN_MS)
    dt = time.perf_counter() - t0
    live = [int(p) for p in recs[-1].prn if p]
    sh = mgr._state
    print(f"ran {RUN_MS} ms over {n_dev} devices in {dt:.1f}s; "
          f"live PRNs: {sorted(live)}")
    print(f"state sharding: {sh}")
    assert sorted(live), "no channels tracking"
    parts = [str(p.corr.sample_pos.device) for p in sh.parts] \
        if isinstance(sh, Sharded) else None
    assert isinstance(sh, Sharded) and sh.mesh is mesh and parts == [
        str(d) for d in mesh.axis_devices("channel")], \
        "state not on the mesh"
    for rec in recs[-1:]:
        for prn, dopp, cn0 in zip(rec.prn, rec.doppler_hz, rec.cn0_dbhz):
            if prn:
                print(f"  PRN {prn:2d}: doppler {dopp:+8.1f} Hz  "
                      f"C/N0 {cn0:4.1f} dB-Hz")
    print("OK")
    return {"signal_s": RUN_MS / 1000.0, "wall_s": dt,
            "n_devices": n_dev, "mesh": repr(mesh), "engine": mgr.engine,
            "live_prns": sorted(live), "state_parts": parts}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=2,
                    help="shards on the mesh's channel axis (default 2)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without a "
                    "card)")
    args = ap.parse_args()
    main(args.device, args.n_devices)
