"""The port's parallel/ (meshes of torch devices, channel-sharded
tracking, sharded acquisition, time-block long coherent acquisition)
against gnsstpu's, at tests/test_parallel.py's sizes.

The reference runs on tests/conftest.py's 8 virtual CPU devices, Pallas
in interpret mode; the port on CPU meshes of repeated devices
(devices=["cpu"] * n), where each shard runs its kernel's plain twin.
Sharded against unsharded is bit-exact in the port, as in the reference,
for the fused and gather trackers and for the ChannelManager's records
and prompt streams; also for the Galileo E1B and GLONASS L3OC managers,
whose K2 and K3 (the reference has no sharded ones) run per shard.
Port against reference: acquisition at
test_torch_acquisition.py's tolerances, K1 at test_track_kernel.py's,
the managers at test_torch_manager.py's, the long coherent search
against the reference's and the f64 oracle at normalised atol 2e-3.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnsstpu.config import AcqConfig, ReceiverConfig, SignalConfig, TrackConfig
from gnsstpu.ops import fft_acquire as jfft
from gnsstpu.parallel import make_mesh as j_make_mesh
from gnsstpu.parallel import shard_acquisition_inputs as j_shard_acq
from gnsstpu.parallel.fused_shard import make_sharded_fused_tracker as j_sft
from gnsstpu.parallel.fused_shard import shard_fused_inputs as j_sfi
from gnsstpu.parallel.timeblock import long_coherent_acquire as j_long
from gnsstpu.parallel.timeblock import (
    reference_coherent_power as j_reference_coherent_power)
from gnsstpu.runtime.manager import ChannelManager as JManager
from gnsstpu.runtime.sources import ArraySource as JArray
from gnsstpu.runtime.telemetry import Telemetry as JTelemetry
from gnsstpu.sim import IFSimulator, SatParams
from gnsstpu.tracking import scan as jscan
from gnsstpu.tracking.fused import fused_code_table as j_fused_code_table
from gnsstpu_torch.device import u32_tensor
from gnsstpu_torch.ops import code_tables
from gnsstpu_torch.ops import fft_acquire as tfft
from gnsstpu_torch.parallel import (make_mesh, make_sharded_fused_tracker,
                                    shard_acquisition_inputs,
                                    shard_channel_state, shard_fused_inputs)
from gnsstpu_torch.parallel.fused_shard import shard_tracker
from gnsstpu_torch.parallel.mesh import (Sharded, replicate, shard_rows,
                                         tree_leaves)
from gnsstpu_torch.parallel.timeblock import (long_coherent_acquire,
                                              reference_coherent_power)
from gnsstpu_torch.runtime.manager import ChannelManager as TManager
from gnsstpu_torch.runtime.sources import ArraySource as TArray
from gnsstpu_torch.runtime.telemetry import Telemetry as TTelemetry
from gnsstpu_torch.tracking import fused as tfused
from gnsstpu_torch.tracking import scan as tscan
from test_torch_track_kernel import TRK, _compare, _setup
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import to_port

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
TSIG = to_port(SIG)
CPU = torch.device("cpu")

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def cpu_mesh(axes):
    n = int(np.prod([s for _, s in axes]))
    return make_mesh(axes, devices=["cpu"] * n)


def assert_trees_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def sim_samples():
    sats = [SatParams(prn=p, doppler_hz=500.0 * p, code_phase_chips=31.0 * p,
                      cn0_dbhz=46.0) for p in (3, 9, 17, 25)]
    sim = IFSimulator(SIG, sats, noise_sigma=1.0, seed=5)
    return sats, np.asarray(sim.generate(40))


# --- 1. meshes -------------------------------------------------------------

def test_make_mesh_repeated_devices():
    mesh = cpu_mesh([("channel", 2), ("doppler", 4)])
    assert mesh.shape == {"channel": 2, "doppler": 4}
    assert mesh.axis_names == ("channel", "doppler")
    assert mesh.devices.shape == (2, 4)
    assert all(d == CPU for d in mesh.devices.flat)
    assert mesh.axis_devices("channel") == [CPU, CPU]
    assert mesh.distinct_devices() == [CPU]
    assert not mesh.distributed
    with pytest.raises(ValueError, match="need 4 devices"):
        make_mesh([("channel", 4)], devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="no axis"):
        mesh.axis_devices("time")


def test_cuda_mesh_never_falls_back_to_the_cpu():
    """No card: a mesh of the default devices, or of CUDA devices named
    explicitly, raises (the reference falls back to CPU devices)."""
    if torch.cuda.is_available():
        mesh = make_mesh([("channel", 1)])
        assert mesh.first_device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh([("channel", 2)])
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh([("channel", 2)], devices=["cuda"] * 2)


# --- 2. sharded acquisition -------------------------------------------------

def test_sharded_acquisition(sim_samples):
    """tests/test_parallel.py's search on a channel=2 x doppler=4 mesh:
    the port's sharded cube against its unsharded cube (same peaks,
    metric rtol 1e-5) and against the reference's sharded cube."""
    _, samples = sim_samples
    acq = AcqConfig(doppler_band=7e3, coherent_ms=2, threshold=2.5,
                    doppler_step=500.0)
    spc = SIG.samples_per_code
    L = acq.coherent_ms * spc
    lw = jfft.window_len(spc, acq.coherent_ms)
    blocks = np.stack([samples[:lw], samples[L:L + lw]])
    fd_re, fd_im = jfft.code_fd_table(SIG.signal, SIG.fs, SIG.code_freq,
                                      SIG.code_length, acq.coherent_ms)
    dopp = jfft.doppler_grid(0.0, acq.doppler_band, 500.0)
    dopp = np.concatenate([dopp, dopp[-1:] + 500.0]).astype(np.float32)
    spchip = round(SIG.fs / SIG.code_freq)

    jmesh = j_make_mesh([("channel", 2), ("doppler", 4)])
    jcube = np.asarray(jfft.acquire_cube(
        *j_shard_acq(jnp.asarray(blocks), jnp.asarray(fd_re),
                     jnp.asarray(fd_im), jnp.asarray(dopp), jmesh),
        SIG.fs, spc))

    fd = torch.complex(torch.from_numpy(fd_re), torch.from_numpy(fd_im))
    tb, td = torch.from_numpy(blocks), torch.from_numpy(dopp)
    single = tfft.acquire_cube(tb, fd, td, SIG.fs, spc)
    shards = shard_acquisition_inputs(
        tb, fd, td, cpu_mesh([("channel", 2), ("doppler", 4)]))
    assert len(shards.cells) == 8
    assert shards.cells[(1, 3)][2].shape == (16, fd.shape[1])
    cube = tfft.acquire_cube(shards, None, None, SIG.fs, spc)
    got = tfft.peak_metrics(cube, samples_per_code=spc,
                            samples_per_chip=spchip)
    one = tfft.peak_metrics(single, samples_per_code=spc,
                            samples_per_chip=spchip)
    ref = jfft.peak_metrics(jnp.asarray(jcube), samples_per_code=spc,
                            samples_per_chip=spchip)
    for key in ("code_phase", "doppler_bin"):
        np.testing.assert_array_equal(got[key].numpy(), one[key].numpy())
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(ref[key]))
    np.testing.assert_allclose(got["metric"].numpy(), one["metric"].numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(got["metric"].numpy(),
                               np.asarray(ref["metric"]), rtol=1e-3)
    np.testing.assert_allclose(cube.numpy(), jcube, rtol=1e-3,
                               atol=1e-3 * float(jcube.max()))


# --- 3, 4. sharded tracking -------------------------------------------------

def _track_inputs(sats, trk):
    spchip = SIG.fs / SIG.code_freq
    prns = [s.prn for s in sats] * 2           # 8 channels, 4-way shard
    cps = np.array([int(round(s.code_phase_chips * spchip))
                    for s in sats] * 2)
    dops = np.array([s.doppler_hz + 25.0 for s in sats] * 2, np.float32)
    cb, ia = jscan.channel_consts(SIG, trk, prns)
    return prns, cps, dops, cb, ia


def test_sharded_fused_tracking(sim_samples):
    """K1 (its twin) on a 4-way channel split: bit-exact against one
    unsharded call, and against the reference's
    make_sharded_fused_tracker (interpret mode) at K1's tolerances."""
    sats, samples = sim_samples
    trk = TrackConfig(dll_bw=1.0, el_spacing=0.3)
    prns, cps, dops, cb, ia = _track_inputs(sats, trk)
    n_blocks = 6
    chunk = samples[: (n_blocks + 2) * SIG.samples_per_code]
    tab = j_fused_code_table(SIG, trk, prns)

    jmesh = j_make_mesh([("channel", 4)])
    jst = jax.tree.map(jnp.asarray, jscan.TrackState.init(cps, dops))
    js, jt, jc, jch = j_sfi(jst, jnp.asarray(tab),
                            (jnp.asarray(cb), jnp.asarray(ia)),
                            jnp.asarray(chunk), jmesh)
    ref_state, ref_out = j_sft(SIG, trk, mesh=jmesh, n_blocks=n_blocks,
                               interpret=True)(jch, jt, jc, js)

    ttrk = to_port(trk)
    rows = torch.from_numpy(tfused.fused_tap_rows(tab))
    consts = (u32_tensor(cb, CPU), torch.from_numpy(ia))
    st0 = tscan.TrackState.init(cps, dops, device=CPU)
    one_state, one_out = tfused.make_fused_tracker(
        TSIG, ttrk, n_blocks=n_blocks)(torch.from_numpy(chunk), rows,
                                       consts, st0)
    mesh = cpu_mesh([("channel", 4)])
    st_s, tab_s, consts_s, chunk_s = shard_fused_inputs(
        st0, rows, consts, torch.from_numpy(chunk), mesh)
    assert isinstance(st_s, Sharded) and len(tab_s.parts) == 4
    assert list(chunk_s) == [CPU]        # one copy per distinct device
    got_state, got_out = make_sharded_fused_tracker(
        TSIG, ttrk, mesh=mesh, n_blocks=n_blocks)(chunk_s, tab_s, consts_s,
                                                  st_s)
    assert_trees_equal(got_out, one_out)
    assert_trees_equal(got_state.gather(), one_state)
    _compare(got_state.gather(), got_out, ref_state, ref_out, n_blocks)


def test_sharded_gather_tracking(sim_samples):
    """The exact 'gather' scan tracker per shard of a channel=4 x
    doppler=2 mesh: bit-exact against unsharded (the reference's
    tests/test_parallel.py obligation)."""
    sats, samples = sim_samples
    trk = TrackConfig(dll_bw=1.0)
    prns, cps, dops, cb, ia = _track_inputs(sats, trk)
    padded = code_tables.padded_code_table(SIG.signal)
    codes = torch.from_numpy(
        np.stack([padded[p - 1] for p in prns]).astype(np.float32))
    n_blocks = 8
    tracker = tscan.make_tracker(TSIG, to_port(trk), n_blocks=n_blocks)
    chunk = torch.from_numpy(samples[: (n_blocks + 2) * SIG.samples_per_code])
    consts = (u32_tensor(cb, CPU), torch.from_numpy(ia))
    st0 = tscan.TrackState.init(cps, dops, device=CPU)
    ref_state, ref_out = tracker(chunk, codes, consts, st0)

    mesh = cpu_mesh([("channel", 4), ("doppler", 2)])
    st_s, codes_s = shard_channel_state(st0, codes, mesh)
    got_state, got_out = shard_tracker(tracker, mesh)(
        replicate(chunk, mesh), codes_s,
        tuple(shard_rows(c, mesh) for c in consts), st_s)
    assert_trees_equal(got_out, ref_out)
    assert_trees_equal(got_state.gather(), ref_state)


# --- 5. time-block long coherent acquisition -------------------------------

@pytest.fixture(scope="module")
def weak_sky():
    sat = SatParams(prn=3, doppler_hz=100.0, code_phase_chips=412.5,
                    cn0_dbhz=50.0)
    samples = np.asarray(IFSimulator(SIG, [sat], noise_sigma=0.2,
                                     seed=23).generate(10))
    dopp = np.array([-150.0, 100.0, 350.0])
    return sat, samples, dopp, reference_coherent_power(
        samples, TSIG, [3, 9], dopp, 8)


@pytest.mark.parametrize("B", [4, 1])
def test_long_coherent_acquire(weak_sky, B):
    """K = 8 code periods over time=B (B = 1: the tail-only halo) against
    the reference's at the same mesh and the f64 oracle (the port's copy,
    equal to the reference's). The reference runs its matmul-DFT mode,
    which its own tests hold to the oracle at the same tolerance: its
    Stockham mode takes ~50 s per call to compile on the CPU."""
    sat, samples, dopp, want = weak_sky
    np.testing.assert_array_equal(
        want, j_reference_coherent_power(samples, SIG, [3, 9], dopp, 8))
    cube = long_coherent_acquire(samples, TSIG, [3, 9], dopp,
                                 cpu_mesh([("time", B)]),
                                 k_periods=8).numpy()
    ref = np.asarray(j_long(samples, SIG, [3, 9], dopp,
                            j_make_mesh([("time", B)]), k_periods=8,
                            fft_mode="mm"))
    scale = want.max()
    assert np.allclose(cube / scale, want / scale, atol=2e-3)
    assert np.allclose(cube / scale, ref / scale, atol=2e-3)
    p, d, c = np.unravel_index(np.argmax(cube), cube.shape)
    assert (p, d) == (0, 1)
    spc = SIG.samples_per_code
    expect = (sat.code_phase_chips * SIG.fs / SIG.code_freq) % spc
    assert abs((c - expect + spc / 2) % spc - spc / 2) <= 2.0


# --- 6-8. the ChannelManager on a mesh --------------------------------------

def _mgr_cfg():
    return ReceiverConfig(
        signal=SIG,
        acq=AcqConfig(doppler_band=4e3, coherent_ms=2, threshold=2.4,
                      prn_list=(2, 5, 9), fine_doppler_ms=10),
        track=TrackConfig(dll_bw=1.0, el_spacing=0.3), n_channels=4)


@pytest.fixture(scope="module")
def mgr_samples():
    """tests/test_parallel.py::_mgr_parity_run's 3-SV signal."""
    sats = [SatParams(prn=p, doppler_hz=300.0 * (p - 5),
                      code_phase_chips=211.5 * p, cn0_dbhz=47.0)
            for p in (2, 5, 9)]
    return np.asarray(IFSimulator(SIG, sats, noise_sigma=1.0,
                                  seed=13).generate(660))


def _mgr_run(samples, engine, n_ms, mesh=None, reference=False):
    kw = dict(epoch_ms=100, reacq_period_ms=400, cn0_drop_dbhz=35.0,
              prn_pool=[2, 5, 9, 17], sync_every=2, prefetch=True,
              engine=engine, mesh=mesh)
    if reference:
        mgr = JManager(JArray(samples), _mgr_cfg(),
                       telemetry=JTelemetry(sink=io.StringIO()), **kw)
    else:
        mgr = TManager(TArray(samples), to_port(_mgr_cfg()), device="cpu",
                       telemetry=TTelemetry(sink=io.StringIO()), **kw)
    return mgr, mgr.run(n_ms)


LANES = ("i_p", "q_p", "carr_doppler", "abs_sample", "carr_cycles")


def _assert_same_run(m1, r1, m2, r2, sky=(2, 5, 9), n_live=2):
    assert len(r1) == len(r2) > 0
    for a, b in zip(r1, r2):
        for f in ("prn", "cn0_dbhz", "pll_lock", "doppler_hz"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    live = [int(p) for p in r1[-1].prn if p]
    assert len(live) >= n_live and set(live) <= set(sky)
    for prn in live:
        s1, s2 = m1.prompt_stream(prn), m2.prompt_stream(prn)
        assert sorted(s1) == sorted(s2)
        for key in LANES + tuple(k for k in ("i_p2", "q_p2") if k in s1):
            np.testing.assert_array_equal(s1[key], s2[key],
                                          err_msg=f"{prn} {key}")


@pytest.mark.parametrize("engine", ["gather", "fused"])
def test_manager_mesh_matches_unsharded(mgr_samples, engine):
    """ChannelManager(mesh=channel 2): records and prompt streams
    bit-exact against the unsharded manager; 'fused' (K1 once per shard)
    also against the reference's sharded manager."""
    n_ms = 400 if engine == "fused" else 600
    m1, r1 = _mgr_run(mgr_samples, engine, n_ms)
    m2, r2 = _mgr_run(mgr_samples, engine, n_ms,
                      mesh=cpu_mesh([("channel", 2)]))
    _assert_same_run(m1, r1, m2, r2)
    # The sharded run really kept its state on the mesh.
    assert isinstance(m2._state, Sharded) and len(m2._state.parts) == 2
    assert m2._state.parts[0].corr.sample_pos.shape == (2,)
    if engine != "fused":
        return
    jm, jr = _mgr_run(mgr_samples, engine, n_ms,
                      mesh=j_make_mesh([("channel", 2)]), reference=True)
    for a, b in zip(r2, jr):
        np.testing.assert_array_equal(a.prn, b.prn)
    assert [(s.prn, s.state.value) for s in m2.slots] == \
        [(s.prn, s.state.value) for s in jm.slots]
    for prn in (int(p) for p in jr[-1].prn if p):
        h, g = m2.prompt_stream(prn), jm.prompt_stream(prn)
        for lane in ("i_p", "q_p"):
            np.testing.assert_allclose(h[lane], g[lane], rtol=2e-3,
                                       atol=2.0, err_msg=lane)
        np.testing.assert_allclose(h["carr_doppler"], g["carr_doppler"],
                                   rtol=0, atol=0.05)


def _family_cfg(family):
    """(config, sky, manager options) of a K2 or K3 family at
    test_torch_boc.py's and test_torch_dual.py's sizes, with both of
    their satellites in the sky, one per shard of a channel=2 mesh."""
    if family == "galileo_e1b":
        from test_torch_boc import SATS, SIG as GSIG, TRK as GTRK
        acq = AcqConfig(doppler_band=2000.0, coherent_ms=1, threshold=2.2,
                        doppler_step=125.0, prn_list=(11, 4))
        kw = dict(epoch_ms=400, confirm_epochs=3)
        return (ReceiverConfig(signal=GSIG, acq=acq, track=GTRK,
                               n_channels=2), SATS, kw)
    from test_torch_dual import PRNS, SIG as LSIG, TRK as LTRK, sky
    acq = AcqConfig(doppler_band=3000.0, coherent_ms=1, threshold=2.5,
                    doppler_step=250.0, prn_list=tuple(PRNS))
    kw = dict(epoch_ms=100, confirm_epochs=2)
    return (ReceiverConfig(signal=LSIG, acq=acq, track=LTRK, n_channels=2),
            sky(PRNS, 500), kw)


@pytest.mark.parametrize("engine", ["gather", "fused"])
@pytest.mark.parametrize("family,n_ms", [("galileo_e1b", 800),
                                         ("glonass_l3oc", 400)])
def test_boc_and_dual_managers_under_a_mesh(family, n_ms, engine):
    """Galileo E1B and GLONASS L3OC managers on a channel=2 mesh run their
    engine's tracker per shard (K2 / K3's twin for 'fused', the exact
    scan for 'gather'): records and prompt streams, the data prompts
    included, bit-exact against the unsharded manager; the codes and
    carrier bases split over the mesh, Galileo's shared subcarrier rows
    whole. (The reference resolves both families to their scan engines
    under a mesh; the port keeps K2 and K3.)"""
    cfg, sats, kw = _family_cfg(family)
    samples = np.asarray(IFSimulator(cfg.signal, sats, noise_sigma=1.0,
                                     seed=4).generate(n_ms + 100))
    runs = []
    for mesh in (None, cpu_mesh([("channel", 2)])):
        mgr = TManager(TArray(samples), to_port(cfg), device="cpu",
                       telemetry=TTelemetry(sink=io.StringIO()),
                       reacq_period_ms=10 ** 9, sync_every=2, prefetch=True,
                       engine=engine, prn_pool=list(cfg.acq.prn_list),
                       mesh=mesh, **kw)
        runs.append((mgr, mgr.run(n_ms)))
    (m1, r1), (m2, r2) = runs
    want = {"galileo_e1b": {"gather": "boc", "fused": "boc_fused"},
            "glonass_l3oc": {"gather": "dual", "fused": "dual_fused"}}
    assert m1.engine == m2.engine == want[family][engine]
    _assert_same_run(m1, r1, m2, r2, sky=set(cfg.acq.prn_list), n_live=2)
    assert isinstance(m2._state, Sharded) and len(m2._state.parts) == 2
    bank = m2._bank_dev
    for key in m2.eng.channel_keys:
        assert isinstance(bank[key], Sharded), key
    if family == "galileo_e1b":
        assert isinstance(bank["sub"], torch.Tensor)


def test_checkpoint_resumes_sharded(mgr_samples, tmp_path):
    """A bank saved by an unsharded manager, restored into a
    ChannelManager(mesh=channel 2): the state comes back split over the
    mesh and the run continues bit-exact against an unsharded
    restore."""
    path = str(tmp_path / "bank.npz")
    m0, _ = _mgr_run(mgr_samples, "fused", 200)
    m0.save_checkpoint(path)
    runs = []
    for mesh in (None, cpu_mesh([("channel", 2)])):
        mgr = TManager(TArray(mgr_samples), to_port(_mgr_cfg()),
                       device="cpu", telemetry=TTelemetry(sink=io.StringIO()),
                       epoch_ms=100, reacq_period_ms=400,
                       cn0_drop_dbhz=35.0, prn_pool=[2, 5, 9, 17],
                       sync_every=2, prefetch=True, engine="fused",
                       mesh=mesh)
        mgr.restore_checkpoint(path)
        if mesh is not None:
            assert isinstance(mgr._state, Sharded)
        runs.append((mgr, mgr.run(200)))
    (m1, r1), (m2, r2) = runs
    _assert_same_run(m1, r1, m2, r2)
    assert isinstance(m2._state, Sharded)


# --- the launchers select the tensors' card --------------------------------

@pytest.mark.cuda
def test_k1_launches_on_the_tensors_card():
    """With cuda:0 current, K1 on cuda:1 tensors launches on cuda:1 (the
    launcher selects the tensors' card for the kernel's attributes and
    stream): its outputs equal the same launch on cuda:0, and a channel=2
    mesh over both cards equals one launch."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (the kernel has no CPU mode)")
    prns, chunk, tab, cb, ia, cp, dp = _setup(4, 12)
    rows = tfused.fused_tap_rows(tab)
    ttrk = to_port(TRK)
    inputs = {}
    res = []
    with torch.cuda.device(0):
        for d in (torch.device("cuda", 0), torch.device("cuda", 1)):
            inputs[d] = (torch.tensor(chunk, device=d),
                         torch.tensor(rows, device=d),
                         (u32_tensor(cb, d), torch.tensor(ia, device=d)),
                         tscan.TrackState.init(cp, dp, device=d))
            st, out = tfused.make_fused_tracker(TSIG, ttrk, n_blocks=12)(
                *inputs[d])
            assert out.ip.device == d
            res.append([t.cpu() for t in tree_leaves((out, st))])
        mesh = make_mesh([("channel", 2)], devices=["cuda:0", "cuda:1"])
        chunk0, rows0, consts0, st0 = inputs[torch.device("cuda", 0)]
        st_s, tab_s, consts_s, chunk_s = shard_fused_inputs(
            st0, rows0, consts0, chunk0, mesh)
        st, out = make_sharded_fused_tracker(TSIG, ttrk, mesh=mesh,
                                             n_blocks=12)(
            chunk_s, tab_s, consts_s, st_s)
        assert st_s.parts[1].corr.sample_pos.device.index == 1
        res.append([t.cpu() for t in tree_leaves((out, st.gather()))])
    for other in res[1:]:
        for a, b in zip(res[0], other):
            assert torch.equal(a, b)
