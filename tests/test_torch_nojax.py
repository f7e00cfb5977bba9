"""The port never reaches JAX or the JAX package: a fresh interpreter whose
import system refuses `jax`, `jaxlib` and every `gnsstpu` module imports
every gnsstpu_torch module and runs three small slices of the live
receiver on the CPU (port simulator -> packed sm2 source -> ChannelManager
-> records): GPS L1 C/A with the fused engine (K1's twin), Galileo E1B
with the exact scan engine ('gather') and GLONASS L3OC pilot + data with
the fused engine (K3's twin). A GPU host need not have JAX
installed, and the port carries its own copies of the reference's host
modules, so any such import would be a fault.

The subprocess also runs the bench module's tracking measurement on the
CPU (K1's twin). The entry points run on the card unless the caller asks
for the CPU: without a card, acquire(), IFSimulator, ChannelManager and
the others below, the bench module's measurements among them, called
without a device raise instead of running on the CPU.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from torch_port import one_torch_thread_per_worker  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, io, pkgutil, sys

    REFUSED = ("jax", "jaxlib", "gnsstpu")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"refused import of {name}")
            return None

    assert not [m for m in sys.modules if m.split(".")[0] in REFUSED]
    sys.meta_path.insert(0, Refuse())

    import gnsstpu_torch
    for mod in pkgutil.walk_packages(gnsstpu_torch.__path__,
                                     "gnsstpu_torch."):
        importlib.import_module(mod.name)

    import numpy as np
    from gnsstpu_torch import AcqConfig, ReceiverConfig, SignalConfig
    from gnsstpu_torch import TrackConfig
    from gnsstpu_torch.runtime import Telemetry
    from gnsstpu_torch.runtime.manager import ChannelManager, SlotState
    from gnsstpu_torch.runtime.sources import PackedArraySource
    from gnsstpu_torch.signals import galileo_e1
    from gnsstpu_torch.runtime.receiver import run_receiver
    from gnsstpu_torch.sim import IFSimulator, SatParams
    from gnsstpu_torch.signals import galileo_e1, glonass_l3
    from gnsstpu_torch.tracking.boc import track_boc
    from gnsstpu_torch.tracking.driver import ChannelInit, track
    from gnsstpu_torch.tracking.dual import track_dual
    from gnsstpu_torch import TrackConfig
    from gnsstpu_torch.bench import bench_manager, bench_tracking

    sig = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
    gsig = SignalConfig(signal="galileo_e1b", if_freq=0.0, fs=4.2e6,
                        code_freq=galileo_e1.SUB_FREQ,
                        code_length=galileo_e1.SUB_LENGTH)
    lsig = SignalConfig(signal="glonass_l3oc", if_freq=0.0, fs=12.0e6,
                        code_freq=glonass_l3.CODE_FREQ,
                        code_length=glonass_l3.CODE_LENGTH)
    chans = [ChannelInit(prn=3, code_phase=0, doppler_hz=0.0)]
    sats = [SatParams(prn=5, doppler_hz=900.0, code_phase_chips=200.5,
                      cn0_dbhz=47.0)]
    x = IFSimulator(sig, sats, noise_sigma=1.0, seed=3,
                    device="cpu").generate(850)
    cfg = ReceiverConfig(
        signal=sig, acq=AcqConfig(doppler_band=6e3, coherent_ms=2,
                                  threshold=2.4, prn_list=(5, 12),
                                  fine_doppler_ms=10),
        track=TrackConfig(dll_bw=1.0), n_channels=2)
    mgr = ChannelManager(PackedArraySource(x, fmt="sm2"), cfg,
                         device="cpu", telemetry=Telemetry(sink=io.StringIO()),
                         epoch_ms=100, reacq_period_ms=400,
                         cn0_drop_dbhz=35.0, prn_pool=[5, 12],
                         sync_every=2, prefetch=True, readback="compact",
                         engine="auto")
    recs = mgr.run(800)
    assert mgr.engine == "fused"
    states = [(s.prn, s.state) for s in mgr.slots]
    assert states[0] == (5, SlotState.TRACKING), states
    assert abs(recs[-1].doppler_hz[0] - 900.0) < 5.0
    n_gps = len(recs)

    gsig = SignalConfig(signal="galileo_e1b", if_freq=0.0, fs=4.2e6,
                        code_freq=galileo_e1.SUB_FREQ,
                        code_length=galileo_e1.SUB_LENGTH)
    gsat = [SatParams(prn=11, doppler_hz=510.0, code_phase_chips=3210.5,
                      cn0_dbhz=48.0)]
    gx = IFSimulator(gsig, gsat, noise_sigma=1.0, seed=4,
                     device="cpu").generate(1300)
    gcfg = ReceiverConfig(
        signal=gsig,
        acq=AcqConfig(doppler_band=1000.0, coherent_ms=1, threshold=2.2,
                      doppler_step=125.0, prn_list=(11,)),
        track=TrackConfig(dll_bw=1.0, el_spacing=0.25, pll_bw=15.0,
                          fll_bw=50.0, sll_bw=0.5, sll_spacing=0.25),
        n_channels=2)
    gmgr = ChannelManager(PackedArraySource(gx, fmt="sm2"), gcfg,
                          device="cpu",
                          telemetry=Telemetry(sink=io.StringIO()),
                          epoch_ms=400, reacq_period_ms=10 ** 9,
                          prn_pool=[11, 20], sync_every=3,
                          engine="gather")
    grecs = gmgr.run(1200)
    assert gmgr.engine == "boc"
    assert grecs[-1].prn[0] == 11, grecs[-1].prn
    assert abs(grecs[-1].doppler_hz[0] - 510.0) < 5.0
    assert len(gmgr.prompt_stream(11)["i_p"]) == 300

    from gnsstpu_torch.signals import glonass_l3
    lsig = SignalConfig(signal="glonass_l3oc", if_freq=0.0, fs=12.0e6,
                        code_freq=glonass_l3.CODE_FREQ,
                        code_length=glonass_l3.CODE_LENGTH)
    ltruth = dict(doppler_hz=1250.0, code_phase_chips=2345.5, cn0_dbhz=50.0)
    lsat = [SatParams(prn=14, nav_bits=np.resize(
                glonass_l3.NH10.astype(np.float32), 300), **ltruth),
            SatParams(prn=46, carrier_phase=np.pi / 2, nav_bits=np.resize(
                glonass_l3.BARKER5.astype(np.float32), 300), **ltruth)]
    lx = IFSimulator(lsig, lsat, noise_sigma=1.0, seed=6,
                     device="cpu").generate(250)
    lcfg = ReceiverConfig(
        signal=lsig,
        acq=AcqConfig(doppler_band=3000.0, coherent_ms=1, threshold=2.5,
                      doppler_step=250.0, prn_list=(14,)),
        track=TrackConfig(dll_bw=1.0, el_spacing=0.3, pll_bw=25.0,
                          fll_bw=250.0, aid_div=117.5),
        n_channels=1)
    lmgr = ChannelManager(PackedArraySource(lx, fmt="sm2"), lcfg,
                          device="cpu",
                          telemetry=Telemetry(sink=io.StringIO()),
                          epoch_ms=100, reacq_period_ms=10 ** 9,
                          prn_pool=[14], sync_every=2, prefetch=True,
                          readback="compact", engine="auto")
    lrecs = lmgr.run(200)
    assert lmgr.engine == "dual_fused"
    assert lrecs[-1].prn[0] == 14, lrecs[-1].prn
    assert abs(lrecs[-1].doppler_hz[0] - 1250.0) < 10.0
    lh = lmgr.prompt_stream(14)
    assert len(lh["q_p2"]) == len(lh["i_p"]) == 200

    from gnsstpu_torch import bench
    brt = bench.bench_tracking(bench.GPS_SIG, bench.GPS_TRK, C=2,
                               n_blocks=2, k_lo=1, k_hi=2, device="cpu")
    assert brt["realtime_factor"] > 0, brt

    loaded = [m for m in sys.modules if m.split(".")[0] in REFUSED]
    assert not loaded, loaded
    print("NOJAX-OK", n_gps, len(grecs), len(lrecs))
""")


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # One torch thread: beside a parallel test run, a thread pool per
    # process oversubscribes the host's cores.
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX-OK 8 3 2" in proc.stdout


@pytest.mark.parametrize("entry", ["acquire", "IFSimulator",
                                   "ChannelManager", "ResampledSource",
                                   "polyphase_resample", "track",
                                   "track_boc", "track_dual",
                                   "run_receiver", "bench_tracking",
                                   "bench_manager"])
def test_entry_points_default_to_the_card(entry):
    """Called without `device`, an entry point asks for the card: on a
    host without one it raises, never quietly running on the CPU."""
    from gnsstpu_torch import AcqConfig, ReceiverConfig, SignalConfig
    from gnsstpu_torch.acquisition.search import acquire
    from gnsstpu_torch.ops.resample import (ResampledSource,
                                            polyphase_resample)
    from gnsstpu_torch.runtime.manager import ChannelManager
    from gnsstpu_torch.runtime.sources import ArraySource
    from gnsstpu_torch.runtime.receiver import run_receiver
    from gnsstpu_torch.sim import IFSimulator, SatParams
    from gnsstpu_torch.signals import galileo_e1, glonass_l3
    from gnsstpu_torch.tracking.boc import track_boc
    from gnsstpu_torch.tracking.driver import ChannelInit, track
    from gnsstpu_torch.tracking.dual import track_dual
    from gnsstpu_torch import TrackConfig
    from gnsstpu_torch.bench import bench_manager, bench_tracking

    sig = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
    gsig = SignalConfig(signal="galileo_e1b", if_freq=0.0, fs=4.2e6,
                        code_freq=galileo_e1.SUB_FREQ,
                        code_length=galileo_e1.SUB_LENGTH)
    lsig = SignalConfig(signal="glonass_l3oc", if_freq=0.0, fs=12.0e6,
                        code_freq=glonass_l3.CODE_FREQ,
                        code_length=glonass_l3.CODE_LENGTH)
    chans = [ChannelInit(prn=3, code_phase=0, doppler_hz=0.0)]
    calls = {
        "acquire": lambda: acquire(
            np.zeros((8 * 2048, 2), np.float32), sig,
            AcqConfig(coherent_ms=1, doppler_band=1e3)),
        "IFSimulator": lambda: IFSimulator(
            sig, [SatParams(prn=1)]).device,
        "ChannelManager": lambda: ChannelManager(
            ArraySource(np.zeros((2048, 2), np.float32)),
            ReceiverConfig(signal=sig, n_channels=1)).device,
        "ResampledSource": lambda: ResampledSource(
            ArraySource(np.zeros((4096, 2), np.float32)), 4.096e6,
            2.048e6).device,
        "polyphase_resample": lambda: polyphase_resample(
            np.zeros((4096, 2), np.float32), 1, 2),
        "track": lambda: track(
            ArraySource(np.zeros((8192, 2), np.float32)), chans, sig,
            TrackConfig(), 2),
        "track_boc": lambda: track_boc(
            ArraySource(np.zeros((8192, 2), np.float32)), chans, gsig,
            TrackConfig(), 2),
        "track_dual": lambda: track_dual(
            ArraySource(np.zeros((8192, 2), np.float32)), chans, lsig,
            TrackConfig(), 2),
        "run_receiver": lambda: run_receiver(
            ArraySource(np.zeros((8 * 2048, 2), np.float32)),
            ReceiverConfig(signal=sig, acq=AcqConfig(coherent_ms=1,
                                                     doppler_band=1e3),
                           n_channels=1), 2),
        "bench_tracking": lambda: bench_tracking(sig, TrackConfig(), 2, 2),
        "bench_manager": lambda: bench_manager(
            sig, seconds=2, n_channels=2, epoch_ms=100, sync_every=2,
            navigate=False),
    }
    if torch.cuda.is_available():
        got = calls[entry]()
        if entry in ("IFSimulator", "ChannelManager", "ResampledSource"):
            assert got.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="is_available"):
        calls[entry]()
