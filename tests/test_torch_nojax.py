"""The port never reaches JAX: a fresh interpreter whose import system
refuses `jax` imports every gnsstpu_torch module and runs a small slice of
the live receiver (port simulator -> packed sm2 source -> ChannelManager
with the fused engine -> records), then checks that jax was never loaded.
A GPU host need not have JAX installed, so any such import would break
chip_smoke.py there."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, io, pkgutil, sys

    class RefuseJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError(f"refused import of {name}")
            return None

    assert "jax" not in sys.modules
    sys.meta_path.insert(0, RefuseJax())

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
    from gnsstpu_torch.sim import IFSimulator, SatParams

    sig = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
    sats = [SatParams(prn=5, doppler_hz=900.0, code_phase_chips=200.5,
                      cn0_dbhz=47.0)]
    x = IFSimulator(sig, sats, noise_sigma=1.0, seed=3).generate(850)
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
    assert "jax" not in sys.modules and "jaxlib" not in sys.modules
    print("NOJAX-OK", len(recs))
""")


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX-OK 8" in proc.stdout
