"""Two-process worker of tests/test_torch_dcn.py: the port's time-sharded
long coherent acquisition across a process boundary.

Launched twice (process_id 0 and 1) on one machine: each process
contributes one CPU device, the pair forms a torch.distributed world
over loopback (gloo), and parallel.timeblock's halo all-gather and
all_reduce run between the processes. The sky and the checks are
tests/dcn_worker.py's, plus the cube against the f64 oracle at
normalised atol 2e-3; the port's simulator draws the reference's noise
(IFSimulator(noise="jax"), without JAX).

Usage: python tests/torch_dcn_worker.py <coordinator> <num_procs> <proc_id>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))       # repo root (gnsstpu_torch package)


def main() -> None:
    coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from gnsstpu_torch.config import SignalConfig
    from gnsstpu_torch.parallel.mesh import make_distributed_mesh
    from gnsstpu_torch.parallel.timeblock import (long_coherent_acquire,
                                                  reference_coherent_power)
    from gnsstpu_torch.sim import IFSimulator, SatParams

    mesh = make_distributed_mesh([("time", nproc)], coordinator=coord,
                                 num_processes=nproc, process_id=pid,
                                 devices=["cpu"])
    # The world really spans processes: one local shard of nproc.
    assert dist.get_world_size() == nproc and mesh.distributed
    assert [int(r) for r in mesh.owners.flat] == list(range(nproc))

    sig = SignalConfig(if_freq=0.0, fs=1.023e6, complex_iq=True)
    sats = [SatParams(prn=7, doppler_hz=500.0, code_phase_chips=123.0,
                      cn0_dbhz=47.0)]
    sim = IFSimulator(sig, sats, noise_sigma=1.0, seed=4, device="cpu",
                      noise="jax")
    k = 4
    spc = sig.samples_per_code
    samples = np.asarray(sim.generate(k + 2))[: k * spc + spc]
    dopp = np.array([0.0, 500.0, 1000.0], np.float32)
    cube = long_coherent_acquire(samples, sig, [5, 7], dopp, mesh,
                                 k_periods=k).numpy()
    # Against the f64 oracle: a wrong halo or a dropped all_reduce term
    # moves every cell by far more than 2e-3 of the peak.
    want = reference_coherent_power(samples, sig, [5, 7], dopp, k)
    err = float(np.max(np.abs(cube - want)) / want.max())
    print(f"ORACLE {pid} max_norm_err={err:.3g}", flush=True)
    assert err <= 2e-3, err
    pi, di, cp = np.unravel_index(int(np.argmax(cube)), cube.shape)
    # PRN 7 (row 1) at 500 Hz (bin 1) at ~123 chips (1 sample/chip).
    print(f"RESULT {pid} prn_row={pi} dopp_bin={di} cp={cp}", flush=True)
    assert (pi, di) == (1, 1), (pi, di, cp)
    assert abs(int(cp) - 123) <= 1, cp
    dist.destroy_process_group()
    print(f"OK {pid}", flush=True)


if __name__ == "__main__":
    main()
