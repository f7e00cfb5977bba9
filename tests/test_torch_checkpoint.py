"""Port checkpoint save / restore of the live channel bank, on the CPU.

  * tests/test_runtime.py's warm restart on a packed sm2 source (the port
    has no SimSource): a manager restored from a bank saved after 800 ms
    resumes TRACKING at the saved stream positions with no channel start
    and no search, at the true Doppler, and its carrier-phase accumulators
    (acc, phase_u32, last_delta) and absolute block counts equal an
    uninterrupted 1,400 ms run's, bit for bit;
  * the file is the reference's format: gnsstpu.runtime.checkpoint.load
    reads a file the port wrote to the same arrays and meta as the port's
    own copy of the loader, and the u32 NCO phases ride int64 in [0, 2^32);
  * a file the reference's manager wrote (gnsstpu's state classes) is
    refused with a ValueError.
"""

import io
import json

import numpy as np
import pytest

from gnsstpu.config import AcqConfig, ReceiverConfig, SignalConfig, TrackConfig
from gnsstpu.runtime import checkpoint as jckpt
from gnsstpu.sim import IFSimulator, SatParams
from gnsstpu_torch.runtime import checkpoint as tckpt
from gnsstpu_torch.runtime.manager import ChannelManager, SlotState
from gnsstpu_torch.runtime.sources import PackedArraySource
from gnsstpu_torch.runtime.telemetry import Telemetry
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import to_port

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
N_MS = 1500


@pytest.fixture(scope="module")
def samples():
    sats = [SatParams(prn=5, doppler_hz=900.0, code_phase_chips=200.5,
                      cn0_dbhz=47.0),
            SatParams(prn=12, doppler_hz=-1500.0, code_phase_chips=700.25,
                      cn0_dbhz=46.0)]
    return np.asarray(IFSimulator(SIG, sats, noise_sigma=1.0,
                                  seed=3).generate(N_MS + 60))


def mk(samples, sink):
    cfg = ReceiverConfig(
        signal=SIG,
        acq=AcqConfig(doppler_band=6e3, coherent_ms=2, threshold=2.4,
                      prn_list=(5, 12), fine_doppler_ms=10),
        track=TrackConfig(dll_bw=1.0), n_channels=3)
    return ChannelManager(
        PackedArraySource(samples, fmt="sm2"), to_port(cfg), device="cpu",
        telemetry=Telemetry(sink=sink), epoch_ms=100, reacq_period_ms=400,
        cn0_drop_dbhz=35.0, prn_pool=[5, 12], sync_every=2)


@pytest.fixture(scope="module")
def saved(samples, tmp_path_factory):
    m1 = mk(samples, io.StringIO())
    m1.run(800)
    assert {s.prn for s in m1.slots if s.prn} == {5, 12}
    path = str(tmp_path_factory.mktemp("ckpt") / "bank.npz")
    m1.save_checkpoint(path)
    return m1, path


def test_warm_restart_no_reacquisition(samples, saved):
    m1, path = saved
    sink = io.StringIO()
    m2 = mk(samples, sink)
    meta = m2.restore_checkpoint(path)
    assert meta["cursor"] == m1._cursor
    m2.run(600)
    evs = [json.loads(ln) for ln in sink.getvalue().splitlines()]
    assert not [e for e in evs if e.get("what") == "channel_start"]
    assert not [e for e in evs if e.get("stage") == "acquire"]
    assert {s.prn for s in m2.slots if s.prn} == {5, 12}
    ch = [e for e in evs if e.get("type") == "channel_health"]
    d5 = [e["doppler_hz"] for e in ch if e.get("prn") == 5][-1]
    d12 = [e["doppler_hz"] for e in ch if e.get("prn") == 12][-1]
    assert abs(d5 - 900.0) < 5.0 and abs(d12 + 1500.0) < 5.0
    for s in m2.slots:
        if s.prn:
            assert s.state is SlotState.TRACKING

    m0 = mk(samples, io.StringIO())
    m0.run(1400)
    for prn in (5, 12):
        a0 = m0.history[prn]["_cph"]
        a2 = m2.history[prn]["_cph"]
        assert a2.acc == a0.acc
        assert a2.phase_u32 == a0.phase_u32
        assert a2.last_delta == a0.last_delta
        n0 = sum(len(x) for x in m0.history[prn]["i_p"])
        n2 = (m2.history[prn]["evicted"]
              + sum(len(x) for x in m2.history[prn]["i_p"]))
        assert n2 == n0


def _leaves(tree):
    if hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in _leaves(getattr(tree, f))]
    return [tree]


def test_file_is_the_reference_format(saved):
    m1, path = saved
    j_state, j_meta, j_ephs, j_extra = jckpt.load(path)
    t_state, t_meta, t_ephs, t_extra = tckpt.load(path)
    assert j_meta == t_meta
    assert j_meta["signal"] == "gps_l1ca"
    assert set(j_meta["cph"]) == {"5", "12"}
    assert j_ephs == t_ephs == {} and j_extra == t_extra == {}
    assert type(j_state) is type(t_state) is type(m1._state)
    jl, tl, ml = _leaves(j_state), _leaves(t_state), _leaves(m1._state)
    assert len(jl) == len(tl) == len(ml) > 0
    for a, b, t in zip(jl, tl, ml):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, t.numpy())
    cph = m1._state.corr.carr_phase_u32.numpy()
    assert cph.dtype == np.int64 and cph.min() >= 0 and cph.max() < 2 ** 32
    for prn, c in j_meta["cph"].items():
        assert int(c["acc"]) == m1.history[int(prn)]["_cph"].acc


def test_reference_file_is_refused(samples, tmp_path):
    """A bank the reference's manager saved names gnsstpu's state classes;
    restoring it would import gnsstpu (and JAX) into the port, so the
    port refuses it before loading anything."""
    from gnsstpu.runtime.manager import ChannelManager as JManager
    from gnsstpu.runtime.sources import PackedArraySource as JPacked
    from gnsstpu.runtime.telemetry import Telemetry as JTelemetry

    cfg = ReceiverConfig(signal=SIG, acq=AcqConfig(prn_list=(5, 12)),
                         track=TrackConfig(dll_bw=1.0), n_channels=3)
    path = str(tmp_path / "ref_bank.npz")
    JManager(JPacked(samples, fmt="sm2"), cfg,
             telemetry=JTelemetry(sink=io.StringIO())).save_checkpoint(path)
    assert jckpt.load(path)[1]["signal"] == "gps_l1ca"
    m = mk(samples, io.StringIO())
    with pytest.raises(ValueError, match="gnsstpu_torch"):
        m.restore_checkpoint(path)
