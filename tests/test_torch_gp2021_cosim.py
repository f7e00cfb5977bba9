"""The GP2021 co-simulation on the port, on the CPU: the firmware loop of
gnsstpu_torch.native.cosim closing DLL + PLL on the port's integer
correlator golden model (Gp2021Channel), against the reference test's
loop (tests/test_gp2021_cosim.py) and the port's float tracker.

The two packages' simulators agree to 1e-4 but for rare chip-edge flips
(tests/test_torch_jaxrand.py), and a flip can move an int8 sample after
the x24 quantizer, so the firmware parity test feeds both loops the same
int8 array and asks for equal traces; the simulators are held to their
own tolerance beside it.
"""

import numpy as np
import pytest

import test_gp2021_cosim as ref
from gnsstpu.sim import IFSimulator as JSim
from gnsstpu.sim import SatParams as JSat
from gnsstpu_torch.config import AcqConfig, ReceiverConfig, SignalConfig
from gnsstpu_torch.native import cosim
from gnsstpu_torch.runtime.manager import ChannelManager
from gnsstpu_torch.runtime.sources import SimSource
from gnsstpu_torch.sim import IFSimulator, SatParams
from torch_port import (  # noqa: F401
    one_torch_thread_per_worker, reference_native_library)

SIG = SignalConfig(if_freq=0.0, fs=cosim.FS, complex_iq=True)


def _port_iq(sats, n_ms: int, seed: int) -> np.ndarray:
    sim = IFSimulator(SIG, sats, noise_sigma=0.35, seed=seed, device="cpu",
                      noise="jax")
    return sim.generate(n_ms)


@pytest.mark.parametrize("prn,true,guess,chips,n_ms,seed", [
    (9, 1150.0, 1120.0, 0.25, 400, 11),       # the pull-in test's signal
    (4, -800.0, -780.0, 0.0, 500, 3)])        # the cross-check's
def test_firmware_traces_equal_the_references(prn, true, guess, chips,
                                              n_ms, seed):
    tr_ref = ref.firmware_track(prn=prn, doppler_true=true,
                                doppler_guess=guess, code_phase_chips=chips,
                                n_ms=n_ms, seed=seed)
    jsats = [JSat(prn=prn, doppler_hz=true, code_phase_chips=chips,
                  cn0_dbhz=55.0)]
    jiq = np.asarray(JSim(ref.SIG, jsats, noise_sigma=0.35,
                          seed=seed).generate(n_ms + 2))
    iq8 = cosim.quantize_iq8(jiq)
    tr = cosim.firmware_track(iq8, prn, guess, n_ms)
    assert set(tr) == set(tr_ref) and len(tr["ip"]) >= n_ms - 2
    for k in tr_ref:
        np.testing.assert_array_equal(tr[k], tr_ref[k], err_msg=k)
    # The port's simulator makes the same signal within its tolerance.
    tiq = _port_iq([SatParams(prn=prn, doppler_hz=true,
                              code_phase_chips=chips, cn0_dbhz=55.0)],
                   n_ms + 2, seed)
    amp = np.sqrt(10 ** 5.5 / cosim.FS) * 0.35
    d = np.abs(tiq - jiq)
    edge = d > 1e-4
    assert edge.mean() < 1e-4
    assert np.all(d[edge] < 2.0 * amp + 1e-4)


@pytest.mark.parametrize("prn,true,guess,chips,at_code_start", [
    (9, 1150.0, 1120.0, 0.25, False),          # the reference's, start 0
    (9, 1150.0, 1120.0, 0.25, True),
    (9, 1150.0, 1120.0, 611.6, True),
    (22, -2400.0, -2420.0, 977.3, True)])
def test_closed_loop_pull_in_and_track(prn, true, guess, chips,
                                       at_code_start):
    """tests/test_gp2021_cosim.py:94-112 on the port's signal and
    channel, from sample 0 as there or from the satellite's code start."""
    iq = _port_iq([SatParams(prn=prn, doppler_hz=true,
                             code_phase_chips=chips, cn0_dbhz=55.0)],
                  402, 11)
    start = cosim.code_start_sample(chips, true) if at_code_start else 0
    tr = cosim.firmware_track(cosim.quantize_iq8(iq), prn, guess, 400,
                              start=start)
    checks = cosim.pull_in_checks(tr, true)
    assert all(ok for _, ok in checks.values()), checks


def test_integer_vs_float_tracker_cross_check():
    """tests/test_gp2021_cosim.py:114-149: the port's float tracker
    (ChannelManager, K1's twin on the CPU) against the port's integer
    loop on the same signal, at the reference's limits."""
    sats = [SatParams(prn=4, doppler_hz=-800.0, code_phase_chips=0.0,
                      cn0_dbhz=55.0)]
    sim = IFSimulator(SIG, sats, noise_sigma=0.35, seed=3, device="cpu",
                      noise="jax")
    tr = cosim.firmware_track(cosim.quantize_iq8(sim.generate(502)), 4,
                              -780.0, 500)
    cfg = ReceiverConfig(signal=SIG, acq=AcqConfig(coherent_ms=2),
                         n_channels=1)
    mgr = ChannelManager(SimSource(sim, 520), cfg, prn_pool=[4],
                         epoch_ms=100, device="cpu")
    mgr.run(500)
    h = mgr.prompt_stream(4)
    f_env = np.hypot(np.asarray(h["i_p"]), np.asarray(h["q_p"]))
    i_env = np.hypot(tr["ip"], tr["qp"])
    checks = cosim.envelope_checks(i_env, f_env)
    assert all(ok for _, ok in checks.values()), checks
    assert abs(np.mean(tr["doppler"][-100:]) + 800.0) < 3.0
    assert abs(np.mean(np.asarray(h["carr_doppler"])[-100:]) + 800.0) < 3.0
