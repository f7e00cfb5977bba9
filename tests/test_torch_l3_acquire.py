"""The port's cold search of GLONASS L3OC pilot + data at the benchmark
cell's front end (portbench/configs/glonass_l3oc_12ch.json: 24 Msps
complex, IF -2.025 MHz, sm2, 1 ms coherent, 250 Hz bins, threshold 2.5),
on the CPU.

Each case makes the leading 12 ms of a recording of the cell's sky with
the benchmark's own generator (portbench/gen: the hostfed_9s sky of 8
satellites at 48 dB-Hz and 2 absent PRNs, drawn from the seed), its
noise drawn for the first 4 ms and the next 8 ms as two pieces, and
quantizes it to the sm2 levels the cell feeds. The search reads the
first 3 ms, where on these seeds a satellite's pilot code alone read
lowest (1.85-2.23 against the 2.5 threshold): searched on its pilot and
data codes' summed power (acquisition/search.py::combine_components),
every satellite in the sky is detected and neither absent PRN is, and
the 10 ms fine Doppler hands each over within 20 Hz of its Doppler (the
search's bins are 250 Hz).
"""

import numpy as np
import pytest
import torch

from gnsstpu_torch.acquisition.search import acq_samples_needed, acquire
from portbench import plan, system
from portbench.gen import ifsim, sky as skymod
from torch_port import one_torch_thread_per_worker  # noqa: F401

CFG = plan.load_json(plan.HERE / "configs" / "glonass_l3oc_12ch.json")
TRAFFIC = plan.load_json(plan.HERE / "traffic" / "hostfed_9s.json")


def leading_levels(sky, seed: int) -> np.ndarray:
    """The first 12 ms of a recording of the sky as f32 [N, 2] sm2
    levels, its noise drawn for 0-4 ms and 4-12 ms."""
    sim = ifsim.IFSim(sky, noise_sigma=1.0, seed=seed, device="cpu")
    x = torch.cat([sim.generate(4, 0), sim.generate(8, 4)])
    return ifsim.sm2_levels(ifsim.pack_sm2(x)).numpy()


@pytest.mark.parametrize("seed,weakest", [(2500000016, 26),
                                          (2500000019, 18),
                                          (2500000022, 26),
                                          (2500000041, 22)])
def test_cold_search_finds_every_satellite(one_torch_thread_per_worker,
                                           seed, weakest):
    sky = skymod.make_sky(CFG, TRAFFIC, seed)
    assert weakest in sky.prns
    rcfg = system.receiver_config(CFG, sky.prns + sky.absent)
    x = leading_levels(sky, seed)
    res = acquire(x[:acq_samples_needed(rcfg.signal, rcfg.acq)],
                  rcfg.signal, rcfg.acq, device="cpu")
    assert res.combined
    assert res.detected_prns() == sorted(sky.prns), {
        p: float(res.peak_metric[p - 1]) for p in sky.prns + sky.absent}
    err = {s.prn: res.carr_freq[s.prn - 1] - rcfg.signal.if_freq
           - s.doppler_hz for s in sky.sats if s.prn in sky.prns}
    assert max(abs(e) for e in err.values()) < 20.0, err
