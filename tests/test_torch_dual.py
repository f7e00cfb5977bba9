"""The port's GLONASS L3OC path vs gnsstpu's, on the CPU at 12 Msps complex.

Same numpy-made samples (gnsstpu's IFSimulator: each satellite a pilot
code(prn) x NH(10) and a data code(prn + 32) x Barker(5) x symbols in
quadrature, C/N0 50 dB-Hz) through the JAX function and its port, at
tests/test_glonass_l3.py's fused-kernel size (R = 128 rows, blkp = 12002):
  * dual_tap_rows: every tap equal to the reference's dual_fused_table
    (the port keeps its six used planes as int8, each plane padded with
    zeros to 128 lanes), edge rows included;
  * correlate_block_dual and the exact dual scan over 20 blocks: block
    geometry and cursors exact; the twelve accumulators within atol 8e-3
    (f32 summation order over a 12,000-sample block, as
    tests/test_torch_boc.py's bound for 16,800), loop outputs within 1e-3;
  * kernel K3's plain twin (the CPU path of the wrapper) against the
    reference's Pallas kernel in interpret mode: blksize and sample_pos
    exact; accumulators at K1's tolerances with the absolute part scaled
    to the 6x longer block (rtol 2e-3, atol 12); carrier Doppler 0.05 Hz;
    remainder 5e-4 chips; carrier phase within one LSB step per block;
  * acquisition on pilot + data power with a 10 ms fine Doppler (the
    port's deviations): the reference's cube with each data row added
    into its pilot row gives the port's metrics, code phases and Doppler
    bins, the reference's refine_doppler its carrier;
  * the ChannelManager with DualEngine (scan and fused twin) against
    gnsstpu's (asked for the 10 ms fine Doppler the port applies unasked)
    on one satellite with compact readback: the same slots, the
    pilot and data prompt histories within rtol 2e-3 / atol 12, Doppler
    within 0.05 Hz, and one live_nav_unsupported event.
The CUDA kernel itself is compared with the twin by the test marked
`cuda` (skipped without a card) and by chip_smoke.py on the H100.
"""

import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnsstpu.acquisition import search as jsearch
from gnsstpu.config import (AcqConfig, NavConfig, ReceiverConfig,
                            SignalConfig, TrackConfig)
from gnsstpu.nav import glonass_l3 as jl3nav
from gnsstpu.nav.viterbi import conv_encode
from gnsstpu.ops import fft_acquire as jfft
from gnsstpu.ops.dualcode import correlate_block_dual as j_correlate
from gnsstpu.runtime.manager import ChannelManager as JManager
from gnsstpu.runtime.navigator import OnlineNavigator as JNavigator
from gnsstpu.runtime.sources import PackedArraySource as JPacked
from gnsstpu.runtime.telemetry import Telemetry as JTelemetry
from gnsstpu.signals import glonass_l3
from gnsstpu.sim import IFSimulator, SatParams
from gnsstpu.tracking import dual as jdual
from gnsstpu.tracking.scan import TrackState as JTrackState
from gnsstpu_torch.acquisition import search as tsearch
from gnsstpu_torch.device import u32_numpy, u32_tensor
from gnsstpu_torch.ops import dualcode as tops
from gnsstpu_torch.ops import track_kernel as tk
from gnsstpu_torch.runtime.manager import ChannelManager as TManager
from gnsstpu_torch.runtime.navigator import OnlineNavigator as TNavigator
from gnsstpu_torch.runtime.sources import PackedArraySource as TPacked
from gnsstpu_torch.runtime.telemetry import Telemetry as TTelemetry
from gnsstpu_torch.tracking import dual as tdual
from gnsstpu_torch.tracking.engines import DualEngine, make_engine
from gnsstpu_torch.tracking.scan import TrackState as TTrackState
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import to_port

SIG = SignalConfig(signal="glonass_l3oc", if_freq=0.0, fs=12.0e6,
                   code_freq=glonass_l3.CODE_FREQ,
                   code_length=glonass_l3.CODE_LENGTH, complex_iq=True)
TRK = TrackConfig(dll_bw=1.0, el_spacing=0.3, pll_bw=25.0, fll_bw=250.0,
                  aid_div=glonass_l3.CARRIER_HZ / glonass_l3.CODE_FREQ)
TSIG, TTRK = to_port(SIG), to_port(TRK)
CPU = torch.device("cpu")
PRNS = [14, 3]
TRUTH = [dict(doppler_hz=1320.0, code_phase_chips=2345.5),
         dict(doppler_hz=-640.0, code_phase_chips=7012.25)]
ACC_ATOL = 8e-3
SPC = SIG.samples_per_code
BLKP = SPC + 2
BP = tk.plane_stride(BLKP)


def sky(prns, n_ms, seed=0):
    """Pilot + data SatParams pairs (tests/test_glonass_l3.py's
    overlay_streams), each satellite with its own random bits."""
    rng = np.random.default_rng(seed)
    sats = []
    for prn, truth in zip(prns, TRUTH):
        sym = 1.0 - 2.0 * conv_encode(rng.integers(0, 2, 4).astype(np.int8),
                                      polys=jl3nav.L3_POLYS,
                                      invert=jl3nav.L3_INVERT)
        pilot = np.resize(glonass_l3.NH10.astype(np.float32), n_ms)
        data = (np.repeat(np.resize(sym, -(-n_ms // 5)), 5)[:n_ms]
                * np.resize(glonass_l3.BARKER5.astype(np.float32), n_ms))
        sats += [SatParams(prn=glonass_l3.pilot_prn(prn), nav_bits=pilot,
                           carrier_phase=0.0, cn0_dbhz=50.0, **truth),
                 SatParams(prn=glonass_l3.data_prn(prn), nav_bits=data,
                           carrier_phase=np.pi / 2, cn0_dbhz=50.0, **truth)]
    return sats


def padded(prns, comp):
    c = [glonass_l3.generate_l3_code(comp(p)) for p in prns]
    return np.stack([np.concatenate([x[-1:], x, x[:1]]) for x in c]
                    ).astype(np.float32)


@pytest.fixture(scope="module")
def chunk():
    return np.asarray(IFSimulator(SIG, sky(PRNS, 40), noise_sigma=1.0,
                                  seed=8).generate(26))


@pytest.fixture(scope="module")
def handoff():
    """(code phase [samples], Doppler) per channel, 30 Hz off the truth."""
    spchip = SIG.fs / SIG.code_freq
    cp = np.array([int(round(t["code_phase_chips"] * spchip)) % SPC
                   for t in TRUTH])
    dp = np.array([t["doppler_hz"] + 30.0 for t in TRUTH], np.float32)
    return cp, dp, np.zeros(2, np.uint32)


@pytest.fixture(scope="module")
def ref_table():
    return jdual.dual_fused_table(SIG, TRK, PRNS)


def _jstate(cp, dp):
    return jax.tree.map(jnp.asarray,
                        JTrackState.init(cp, dp, aid_div=TRK.aid_div))


def _tstate(cp, dp):
    return TTrackState.init(cp, dp, aid_div=TRK.aid_div, device=CPU)


def test_dual_tap_rows_equal_reference_table(ref_table):
    tab = tdual.dual_tap_rows(TSIG, TTRK, PRNS)
    assert tdual.dual_fused_span(TSIG) == jdual.dual_fused_span(SIG) == 1.0
    assert BP == 12032 and BP % 128 == 0
    assert tab.dtype == np.int8 and tab.shape == (2, 128, 6, BP)
    assert tdual.dual_table_shape(TSIG) == tab.shape[1:]
    # Every tap the kernel can read, edge rows included; the padding is 0.
    np.testing.assert_array_equal(tab[..., :BLKP], ref_table[:, :, :6, :BLKP])
    assert not tab[..., BLKP:].any()
    np.testing.assert_array_equal(tdual.dual_tap_rows(TSIG, TTRK, [3]),
                                  tab[1:])


def test_correlate_block_dual_matches_reference(chunk, handoff):
    cp, dp, cb = handoff
    kw = dict(spacing=0.3, code_length=SIG.code_length,
              base_code_step=float(np.float64(SIG.code_freq) / SIG.fs),
              inv_fs=1.0 / SIG.fs, blkmax=BLKP)
    pilot = padded(PRNS, glonass_l3.pilot_prn)
    data = padded(PRNS, glonass_l3.data_prn)
    st = _jstate(cp, dp).corr._replace(
        rem_code_phase=jnp.asarray([0.1, -0.05], jnp.float32),
        carr_phase_u32=jnp.asarray([123456789, 4000000000], jnp.uint32))
    jout, jst = jax.vmap(
        lambda p, d, cbase, s: j_correlate(jnp.asarray(chunk), p, d, cbase,
                                           s, **kw))(
        jnp.asarray(pilot), jnp.asarray(data), jnp.asarray(cb), st)
    tst = _tstate(cp, dp).corr._replace(
        rem_code_phase=torch.tensor([0.1, -0.05]),
        carr_phase_u32=u32_tensor(np.asarray(st.carr_phase_u32), CPU))
    tout, tnew = tops.correlate_block_dual(
        torch.tensor(chunk), torch.tensor(pilot), torch.tensor(data),
        u32_tensor(cb, CPU), tst, **kw)
    np.testing.assert_array_equal(tout.blksize.numpy(),
                                  np.asarray(jout.blksize))
    np.testing.assert_array_equal(tnew.sample_pos.numpy(),
                                  np.asarray(jst.sample_pos))
    np.testing.assert_array_equal(u32_numpy(tnew.carr_phase_u32),
                                  np.asarray(jst.carr_phase_u32))
    for name in tout._fields:
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-5, atol=ACC_ATOL, err_msg=name)


def test_dual_scan_matches_reference(chunk, handoff):
    cp, dp, cb = handoff
    nb = 20
    pilot = padded(PRNS, glonass_l3.pilot_prn)
    data = padded(PRNS, glonass_l3.data_prn)
    js, jo = jdual.make_dual_tracker(SIG, TRK, n_blocks=nb)(
        jnp.asarray(chunk), jnp.asarray(pilot), jnp.asarray(data),
        jnp.asarray(cb), _jstate(cp, dp))
    ts, to = tdual.make_dual_tracker(TSIG, TTRK, n_blocks=nb)(
        torch.tensor(chunk), torch.tensor(pilot), torch.tensor(data),
        u32_tensor(cb, CPU), _tstate(cp, dp))
    np.testing.assert_array_equal(to.acc.blksize.numpy(),
                                  np.asarray(jo.acc.blksize))
    np.testing.assert_array_equal(ts.corr.sample_pos.numpy(),
                                  np.asarray(js.corr.sample_pos))
    np.testing.assert_array_equal(to.acc.rem_code_phase.numpy(),
                                  np.asarray(jo.acc.rem_code_phase))
    # XLA's CPU backend fuses t = rem + k * step into one multiply-add;
    # the port (and K3) rounds the product first. Where t + off lands on
    # a chip boundary, one sample's tap flips, moving that block's
    # accumulator by at most 2 |x| (one baseband sample); elsewhere the
    # accumulators agree within ACC_ATOL.
    flip = 2.0 * float(np.abs(chunk).max())
    off = []
    for name in to.acc._fields[:12]:
        d = np.abs(getattr(to.acc, name).numpy()
                   - np.asarray(getattr(jo.acc, name)))
        assert d.max() <= flip + ACC_ATOL, name
        off.append(d > 1e-5 * np.abs(np.asarray(getattr(jo.acc, name)))
                   + ACC_ATOL)
    assert np.any(off, axis=0).sum() <= 2      # of 20 blocks x 2 channels
    for name in to._fields[1:]:
        np.testing.assert_allclose(getattr(to, name).numpy(),
                                   np.asarray(getattr(jo, name)),
                                   rtol=1e-5, atol=1e-3, err_msg=name)


def test_k3_twin_matches_reference_kernel(chunk, handoff, ref_table):
    cp, dp, cb = handoff
    nb = 12
    ref = jdual.make_fused_dual_tracker(SIG, TRK, n_blocks=nb,
                                        interpret=True)
    rs, ro = ref(jnp.asarray(chunk), jnp.asarray(ref_table),
                 jnp.asarray(cb), _jstate(cp, dp))
    port = tdual.make_fused_dual_tracker(TSIG, TTRK, n_blocks=nb)
    before = tk.LAUNCHES["track_chunk_dual_fused"]
    gs, go = port(torch.tensor(chunk),
                  torch.tensor(tdual.dual_tap_rows(TSIG, TTRK, PRNS)),
                  u32_tensor(cb, CPU), _tstate(cp, dp))
    # The plain twin ran: no kernel launch was counted.
    assert tk.LAUNCHES["track_chunk_dual_fused"] == before
    np.testing.assert_array_equal(go.acc.blksize.numpy(),
                                  np.asarray(ro.acc.blksize))
    np.testing.assert_array_equal(gs.corr.sample_pos.numpy(),
                                  np.asarray(rs.corr.sample_pos))
    for name in go.acc._fields[:12]:
        np.testing.assert_allclose(getattr(go.acc, name).numpy(),
                                   np.asarray(getattr(ro.acc, name)),
                                   rtol=2e-3, atol=12.0, err_msg=name)
    np.testing.assert_allclose(go.carr_doppler.numpy(),
                               np.asarray(ro.carr_doppler), rtol=0,
                               atol=0.05)
    np.testing.assert_allclose(go.acc.rem_code_phase.numpy(),
                               np.asarray(ro.acc.rem_code_phase), rtol=0,
                               atol=5e-4)
    d = (u32_numpy(gs.corr.carr_phase_u32).astype(np.int64)
         - np.asarray(rs.corr.carr_phase_u32).astype(np.int64))
    d = (d + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert np.max(np.abs(d)) <= nb * BLKP


def _k3_args(C, blkp, device, tab_dtype=torch.int8):
    return (torch.empty((4096, 2), device=device),
            torch.zeros((C, 4, 6, tk.plane_stride(blkp)), dtype=tab_dtype,
                        device=device),
            torch.zeros((C,), dtype=torch.int32, device=device),
            torch.zeros((C, tk.NF), device=device),
            torch.zeros((C,), dtype=torch.int64, device=device),
            torch.zeros((C,), dtype=torch.int64, device=device))


@pytest.mark.parametrize("case", ["meta_device", "f32_table", "cpu_twin"])
def test_k3_wrapper_checks_its_inputs(case):
    """The wrapper takes the plain twin for CPU tensors of the kernel's
    dtypes only; another device or dtype raises, never runs elsewhere."""
    C, blkp = 2, 64
    kw = dict(n_blocks=2, blkp=blkp, code_length=10230, phases_per_chip=64,
              span_chips=0.0, base_code_step=0.8525, fs=12e6,
              coefs=(1.0,) * 5)
    if case == "meta_device":
        with pytest.raises(ValueError, match="unsupported device"):
            tk.track_chunk_dual_fused(*_k3_args(C, blkp, "meta"), **kw)
    elif case == "f32_table":
        with pytest.raises(TypeError, match="tab dtype"):
            tk.track_chunk_dual_fused(
                *_k3_args(C, blkp, CPU, torch.float32), **kw)
    else:
        before = tk.LAUNCHES["track_chunk_dual_fused"]
        out, ffin, pos, cph = tk.track_chunk_dual_fused(
            *_k3_args(C, blkp, CPU), **kw)
        assert out.shape == (2, C, tk.NOUT_D) and pos.dtype == torch.int32
        assert tk.LAUNCHES["track_chunk_dual_fused"] == before


def test_engine_routing():
    cfg = to_port(ReceiverConfig(signal=SIG, track=TRK, n_channels=2))
    for mode, name in (("auto", "dual_fused"), ("fused", "dual_fused"),
                       ("gather", "dual")):
        eng = make_engine(cfg, mode)
        assert isinstance(eng, DualEngine) and eng.name == name
        assert eng.has_data_component
        assert (eng.period_ms, eng.spc) == (1, SPC)
    fused = make_engine(cfg, "fused")
    bank = fused.new_bank(2)
    assert bank["tab"].shape == (2, 128, 6, BP)
    assert bank["tab"].dtype == np.int8 and fused.slot_keys == ("tab",)
    fused.write_slot(bank, 1, 3)
    np.testing.assert_array_equal(bank["tab"][1],
                                  tdual.dual_tap_rows(TSIG, TTRK, [3])[0])
    scan = make_engine(cfg, "gather")
    bank = scan.new_bank(2)
    scan.write_slot(bank, 0, 14)
    np.testing.assert_array_equal(bank["pilot"][0],
                                  padded([14], glonass_l3.pilot_prn)[0])
    np.testing.assert_array_equal(bank["data"][0],
                                  padded([14], glonass_l3.data_prn)[0])


def _acq():
    # 250 Hz bins: the 2-quadrant FLL pulls in +-250 Hz.
    return AcqConfig(doppler_band=3000.0, coherent_ms=1, threshold=2.5,
                     doppler_step=250.0, prn_list=(14,))


@pytest.fixture(scope="module")
def live_samples():
    return np.asarray(IFSimulator(SIG, sky(PRNS[:1], 500), noise_sigma=1.0,
                                  seed=6).generate(450))


def test_l3_pilot_acquisition_matches_reference(live_samples):
    """The port detects each satellite on its pilot + data power and
    refines its carrier over 10 ms with no fine Doppler configured (two
    deviations; the reference detects on the pilot alone and hands over
    the bin): the reference's own cube over the same windows, each data
    code's row added into its pilot code's, through the reference's
    peak_metrics, gives the port's metrics, code phases and Doppler bins,
    and the reference's refine_doppler from that bin the port's carrier;
    both detect the satellite."""
    acq = _acq()
    x = live_samples[:tsearch.acq_samples_needed(TSIG, to_port(acq))]
    assert len(x) == (tsearch.DUAL_FINE_DOPPLER_MS + 1) * SPC
    ref = jsearch.acquire(x, SIG, acq)
    got = tsearch.acquire(x, TSIG, to_port(acq), device="cpu")
    assert got.combined and got.codes == glonass_l3.NUM_PRN
    assert got.detected_prns() == ref.detected_prns() == [14]
    blocks, combine = jsearch._stack_windows(x, SPC, acq)
    dopp = jfft.doppler_grid(SIG.if_freq, acq.doppler_band,
                             acq.doppler_bin_step())
    cube = np.array(jfft.acquire_cube(
        blocks, *map(jnp.asarray, jfft.code_fd_table(
            SIG.signal, SIG.fs, SIG.code_freq, SIG.code_length,
            acq.coherent_ms)), jnp.asarray(dopp, jnp.float32), SIG.fs, SPC,
        combine=combine))
    off = glonass_l3.data_prn(1) - glonass_l3.pilot_prn(1)
    cube[:glonass_l3.NUM_PRN - off] += cube[off:]
    want = jfft.peak_metrics(jnp.asarray(cube), samples_per_code=SPC,
                             samples_per_chip=round(SIG.fs / SIG.code_freq))
    np.testing.assert_array_equal(got.code_phase,
                                  np.asarray(want["code_phase"]))
    carr = dopp[np.asarray(want["doppler_bin"])]
    carr[13] = jsearch.refine_doppler(x, SIG, 14, int(got.code_phase[13]),
                                      carr[13],
                                      k_ms=tsearch.DUAL_FINE_DOPPLER_MS)
    np.testing.assert_array_equal(got.carr_freq, carr)
    np.testing.assert_allclose(got.peak_metric, np.asarray(want["metric"]),
                               rtol=1e-3)


def _events(sink, what):
    return [r for r in map(json.loads, sink.getvalue().splitlines())
            if r.get("what") == what]


@pytest.mark.parametrize("engine", ["gather", "fused"])
def test_manager_matches_reference(live_samples, engine):
    n_ms = 400
    cfg = ReceiverConfig(signal=SIG, acq=_acq(), track=TRK,
                         nav=NavConfig(), n_channels=2)
    kw = dict(epoch_ms=100, reacq_period_ms=10 ** 9, confirm_epochs=2,
              sync_every=2, prefetch=True, readback="compact",
              engine=engine, prn_pool=[14, 20])
    jsink, tsink = io.StringIO(), io.StringIO()
    # The port refines an L3OC handoff's carrier over 10 ms unasked (a
    # deviation): the reference is asked to.
    jcfg = dataclasses.replace(cfg, acq=dataclasses.replace(
        cfg.acq, fine_doppler_ms=tsearch.DUAL_FINE_DOPPLER_MS))
    jm = JManager(JPacked(live_samples, fmt="sm2"), jcfg,
                  telemetry=JTelemetry(sink=jsink),
                  navigator=JNavigator(SIG, cfg.nav), **kw)
    jr = jm.run(n_ms)
    tcfg = to_port(cfg)
    tm = TManager(TPacked(live_samples, fmt="sm2"), tcfg, device="cpu",
                  telemetry=TTelemetry(sink=tsink),
                  navigator=TNavigator(tcfg.signal, tcfg.nav), **kw)
    tr = tm.run(n_ms)
    assert tm.engine == jm.engine == {"gather": "dual",
                                      "fused": "dual_fused"}[engine]
    assert len(tr) == len(jr) == n_ms // 100
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a.prn, b.prn)
        np.testing.assert_allclose(a.doppler_hz, b.doppler_hz, atol=0.05)
    assert ([(s.prn, s.state.value) for s in tm.slots]
            == [(s.prn, s.state.value) for s in jm.slots])
    assert tr[-1].prn[0] == 14
    assert abs(tr[-1].doppler_hz[0] - 1320.0) < 5.0
    h, g = tm.prompt_stream(14), jm.prompt_stream(14)
    assert len(h["i_p"]) == len(g["i_p"]) == len(h["q_p2"]) == n_ms
    for lane in ("i_p", "q_p", "i_p2", "q_p2"):
        # Compact readback: prompts ship as f16 (one step of 2^-10).
        np.testing.assert_allclose(h[lane], g[lane], rtol=2e-3, atol=12.0,
                                   err_msg=lane)
    np.testing.assert_allclose(h["carr_doppler"], g["carr_doppler"],
                               rtol=0, atol=0.05)
    # The data component rides in quadrature once the loops settle.
    assert np.abs(h["q_p2"][-100:]).mean() > 0.05 * SPC
    assert len(_events(tsink, "live_nav_unsupported")) == 1
    assert len(_events(jsink, "live_nav_unsupported")) == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["twin", "repeat"])
@pytest.mark.parametrize("n_channels", [2, 48])
def test_cuda_k3_matches_plain_twin(cuda_device, chunk, handoff, case,
                                    n_channels):
    """'twin': the kernel against its plain twin; 'repeat': two launches
    on the same inputs are bit-identical (no atomics in the reduction).
    The two channels repeat to n_channels: 2 gives 8 CTAs per cluster and
    one 16-sample step per thread, 48 gives 2 CTAs and several steps."""
    reps = n_channels // len(PRNS)
    cp, dp, cb = (np.tile(a, reps) for a in handoff)
    nb = 12
    tab = np.tile(tdual.dual_tap_rows(TSIG, TTRK, PRNS), (reps, 1, 1, 1))
    port = tdual.make_fused_dual_tracker(TSIG, TTRK, n_blocks=nb)
    devs = (CPU, cuda_device) if case == "twin" else (cuda_device,) * 2
    res = []
    for dev in devs:
        before = tk.LAUNCHES["track_chunk_dual_fused"]
        st, out = port(torch.tensor(chunk, device=dev),
                       torch.tensor(tab, device=dev), u32_tensor(cb, dev),
                       TTrackState.init(cp, dp, aid_div=TRK.aid_div,
                                        device=dev))
        assert tk.LAUNCHES["track_chunk_dual_fused"] == before + (
            dev.type == "cuda")
        res.append((st.corr.sample_pos.cpu(), [t.cpu() for t in out.acc]))
    (rpos, racc), (gpos, gacc) = res
    np.testing.assert_array_equal(gpos.numpy(), rpos.numpy())
    np.testing.assert_array_equal(gacc[12].numpy(), racc[12].numpy())
    for a, b in zip(gacc[:12], racc[:12]):
        if case == "repeat":
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                       atol=12.0)


def _fused_interpret(monkeypatch):
    """The reference's track_dual on its Pallas kernel in interpret mode
    (its fused engine asks for a TPU otherwise); gnsstpu is not edited."""
    import functools

    monkeypatch.setattr(jdual, "make_fused_dual_tracker", functools.partial(
        jdual.make_fused_dual_tracker, interpret=True))


@pytest.mark.parametrize("engine", ["gather", "fused"])
def test_track_dual_matches_reference(live_samples, engine, monkeypatch):
    """The offline driver of both packages over 150 ms in chunks of 64 ms
    (three rebases): 'gather' against 'gather', and the port's 'fused'
    (K3's plain twin) against the reference's Pallas kernel in interpret
    mode, both at K3's tolerances; block geometry exact in both pairings,
    the f64 abs_sample exact for 'gather' and within 5e-4 chip after the
    port's half-slip term for 'fused'. The scan tolerances above hold
    the exact engines for 20 blocks; over 150 closed-loop blocks the two
    exact engines part at block 66, where a last-ulp difference of the two
    math libraries moves pll_disc by 3.5e-4 cycle and the carrier by
    0.025 Hz, and the loop then carries it (accumulators up to 0.7%
    apart, the carrier within 0.03 Hz)."""
    from gnsstpu.runtime.sources import ArraySource as JArraySource
    from gnsstpu.tracking.driver import ChannelInit as JChannelInit
    from gnsstpu_torch.runtime.sources import ArraySource

    if engine == "fused":
        _fused_interpret(monkeypatch)
    n_ms, chunk_ms = 150, 64
    spchip = SIG.fs / SIG.code_freq
    chans = [JChannelInit(prn=14, code_phase=int(round(
        TRUTH[0]["code_phase_chips"] * spchip)) % SPC,
        doppler_hz=TRUTH[0]["doppler_hz"] + 30.0)]
    ref = jdual.track_dual(JArraySource(live_samples), chans, SIG, TRK,
                           n_ms, chunk_ms=chunk_ms, code_mode=engine)
    before = tk.LAUNCHES["track_chunk_dual_fused"]
    got = tdual.track_dual(ArraySource(live_samples),
                           [to_port(c) for c in chans], TSIG, TTRK, n_ms,
                           chunk_ms=chunk_ms, code_mode=engine, device="cpu")
    assert tk.LAUNCHES["track_chunk_dual_fused"] == before
    assert got.i_p.shape == got.q_p2.shape == (1, n_ms)
    np.testing.assert_array_equal(got.prn, ref.prn)
    if engine == "gather":
        np.testing.assert_array_equal(got.abs_sample, ref.abs_sample)
    else:
        # The port's half-slip term (tracking.driver), which the
        # reference's drivers lack, at the nominal block length.
        from gnsstpu_torch.tracking.driver import replica_slip_samples
        slip = replica_slip_samples(
            ref.code_freq - SIG.code_freq,
            np.full(ref.code_freq.shape, SPC), SIG.code_freq)
        np.testing.assert_allclose(got.abs_sample, ref.abs_sample + slip,
                                   rtol=0,
                                   atol=5e-4 * SIG.fs / (SIG.code_freq))
    for name in ("i_p", "q_p", "i_e", "q_e", "i_l", "q_l", "i_p2", "q_p2"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=2e-3, atol=12.0, err_msg=name)
    np.testing.assert_allclose(got.carr_freq, ref.carr_freq, rtol=0,
                               atol=0.05)
    np.testing.assert_allclose(got.code_freq, ref.code_freq, rtol=0,
                               atol=0.05)
    # Pulling in on the pilot: the last 50 ms of Doppler within 10 Hz of
    # the truth (the 30 Hz handoff error settles over ~300 ms).
    assert abs(got.carr_freq[0, -50:].mean() - SIG.if_freq
               - TRUTH[0]["doppler_hz"]) < 10.0
