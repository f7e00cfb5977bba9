"""Port ChannelManager vs gnsstpu's, on test_pipeline.py's small setup
(2 SVs, 3 channels, 850 ms, sync_every 4, 2-bit sm2 wire).

Same source, same config, both managers on the CPU:
  * engine 'gather' on both: the same slot PRNs and slot states at every
    epoch, and prompt/Doppler/abs_sample streams equal to 1e-4 of their
    scale (f32 reduction order and last-ulp libm differences only). The
    compact readback ships prompts as f16 (relative step 2^-10), where a
    last-bit f32 difference can flip one f16 rounding: there the prompts
    are held to one f16 step, rtol 1e-3;
  * engine 'fused' on both (port: K1's plain twin; reference: the Pallas
    kernel in interpret mode): the same slot assignments, prompts within
    test_track_kernel.py's accumulator tolerance (rtol 2e-3, atol 2) and
    Doppler within 0.05 Hz.
"""

import io

import numpy as np
import pytest

from gnsstpu.config import AcqConfig, ReceiverConfig, SignalConfig, TrackConfig
from gnsstpu.runtime.manager import ChannelManager as JManager
from gnsstpu.runtime.sources import PackedArraySource as JPacked
from gnsstpu.runtime.telemetry import Telemetry
from gnsstpu.sim import IFSimulator, SatParams
from gnsstpu_torch.runtime.manager import ChannelManager as TManager
from gnsstpu_torch.runtime.sources import PackedArraySource as TPacked
from gnsstpu_torch.runtime.telemetry import Telemetry as TTelemetry
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import to_port

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
SATS = [
    SatParams(prn=5, doppler_hz=900.0, code_phase_chips=200.5,
              cn0_dbhz=47.0),
    SatParams(prn=12, doppler_hz=-1500.0, code_phase_chips=700.25,
              cn0_dbhz=46.0),
]


@pytest.fixture(scope="module")
def samples():
    return np.asarray(IFSimulator(SIG, SATS, noise_sigma=1.0,
                                  seed=3).generate(850))


def _cfg():
    return ReceiverConfig(
        signal=SIG,
        acq=AcqConfig(doppler_band=6e3, coherent_ms=2, threshold=2.4,
                      prn_list=(5, 12), fine_doppler_ms=10),
        track=TrackConfig(dll_bw=1.0), n_channels=3)


def _run(cls, src, engine, n_ms=800, **kw):
    if cls is TManager:
        cfg, tlm = to_port(_cfg()), TTelemetry(sink=io.StringIO())
        kw["device"] = "cpu"
    else:
        cfg, tlm = _cfg(), Telemetry(sink=io.StringIO())
    mgr = cls(src, cfg, telemetry=tlm, epoch_ms=100, reacq_period_ms=400,
              cn0_drop_dbhz=35.0, prn_pool=[5, 12], sync_every=4,
              engine=engine, **kw)
    recs = mgr.run(n_ms)
    return mgr, recs


def _states(mgr):
    return [(s.prn, s.state.value) for s in mgr.slots]


@pytest.mark.parametrize("prefetch", [False, True])
def test_gather_manager_matches_reference(samples, prefetch):
    kw = dict(prefetch=prefetch, readback="compact" if prefetch else "f32")
    jm, jr = _run(JManager, JPacked(samples, fmt="sm2"), "gather", **kw)
    tm, tr = _run(TManager, TPacked(samples, fmt="sm2"), "gather", **kw)
    assert tm.wire == jm.wire == "sm2"
    assert len(tr) == len(jr) == 8
    for a, b in zip(tr, jr):
        assert a.epoch_ms == b.epoch_ms
        np.testing.assert_array_equal(a.prn, b.prn)
        np.testing.assert_allclose(a.cn0_dbhz, b.cn0_dbhz, atol=1e-2)
    assert _states(tm) == _states(jm)
    assert {p for p, st in _states(tm) if st == "tracking"} == {5, 12}
    for prn in (5, 12):
        h, g = tm.prompt_stream(prn), jm.prompt_stream(prn)
        assert h["start_ms"] == g["start_ms"]
        for lane in ("i_p", "q_p", "carr_doppler", "abs_sample"):
            scale = float(np.max(np.abs(g[lane])))
            rtol = 1e-3 if prefetch and lane in ("i_p", "q_p") else 1e-4
            np.testing.assert_allclose(h[lane], g[lane], rtol=rtol,
                                       atol=1e-4 * scale, err_msg=lane)


def test_fused_manager_matches_reference(samples):
    kw = dict(prefetch=True, readback="compact")
    jm, jr = _run(JManager, JPacked(samples, fmt="sm2"), "fused",
                  n_ms=400, **kw)
    tm, tr = _run(TManager, TPacked(samples, fmt="sm2"), "fused",
                  n_ms=400, **kw)
    assert tm.engine == jm.engine == "fused"
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a.prn, b.prn)
    assert _states(tm) == _states(jm)
    for prn in (5, 12):
        h, g = tm.prompt_stream(prn), jm.prompt_stream(prn)
        for lane in ("i_p", "q_p"):
            np.testing.assert_allclose(h[lane], g[lane], rtol=2e-3,
                                       atol=2.0, err_msg=lane)
        np.testing.assert_allclose(h["carr_doppler"], g["carr_doppler"],
                                   rtol=0, atol=0.05)


def test_unported_options_raise(samples, tmp_path):
    """mesh= builds a sharded manager (its state split over the channel
    axis); a mesh whose axis does not divide the channels raises. A
    checkpoint of another signal is refused; a weak ('sum') tier no longer
    raises: a chunk too short for its search starts the accumulation."""
    from gnsstpu_torch.parallel import make_mesh
    from gnsstpu_torch.parallel.mesh import Sharded

    src = TPacked(samples, fmt="sm2")
    sharded = TManager(src, to_port(_cfg()), device="cpu",
                       mesh=make_mesh([("channel", 3)], devices=["cpu"] * 3))
    assert isinstance(sharded._state, Sharded)
    assert len(sharded._state.parts) == 3
    with pytest.raises(ValueError, match="not divisible"):
        TManager(src, to_port(_cfg()), device="cpu",
                 mesh=make_mesh([("channel", 2)], devices=["cpu"] * 2))
    mgr = TManager(src, to_port(_cfg()), device="cpu")
    path = str(tmp_path / "bank.npz")
    mgr.save_checkpoint(path)
    gal = SignalConfig(signal="galileo_e1b", if_freq=0.0, fs=4.2e6,
                       code_freq=2.046e6, code_length=8184)
    other = TManager(src, to_port(ReceiverConfig(signal=gal, n_channels=3)),
                     device="cpu")
    with pytest.raises(ValueError, match="gps_l1ca"):
        other.restore_checkpoint(path)
    weak = ReceiverConfig(signal=SIG, acq=AcqConfig(doppler_band=1e3).weak(),
                          track=TrackConfig(), n_channels=3)
    wm = TManager(src, to_port(weak), device="cpu", epoch_ms=100)
    assert wm._chunk_len < wm._acq_samples_needed_chunk()
    chunk = wm._to_device(src.read_packed(0, wm._chunk_len))
    assert wm._wk_step(chunk, 0, wm._chunk_len)[0] == "pending"
    assert wm._acq_wk["done"] == 9          # 10 ms windows in 100 ms
