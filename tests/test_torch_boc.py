"""The port's Galileo E1B path vs gnsstpu's, on the CPU at 4.2 Msps.

Same numpy-made samples (gnsstpu's IFSimulator, 2 SVs at C/N0 48 dB-Hz)
through the JAX function and its port:
  * boc_fused_tables: every tap value identical (the port keeps the E/P/L
    planes of the reference's f32 [.., 8, BP] tables as int8, each plane
    padded with zeros to 128 lanes), every tap +-1 and every pad 0, and
    K2's plain twin giving bit-identical outputs on the int8 tables and on
    unpadded f32 ones;
  * correlate_block_boc and the exact scan tracker: block geometry and
    cursors exact; the ten accumulators within atol 8e-3 (f32 summation
    order over a 16,800-sample block: test_torch_scan.py's 2e-3 for a
    2,050-sample block, grown with the square root of the term count and
    rounded up), loop outputs within 1e-3;
  * kernel K2's plain twin (the CPU path of the wrapper) against the
    reference's Pallas kernel in interpret mode, as tests/test_galileo.py
    runs it: blksize and sample_pos exact; accumulators at K1's tolerances
    with the absolute part scaled to the 8x longer block (rtol 2e-3,
    atol 16); carrier Doppler 0.05 Hz; remainders 5e-4; carrier phase
    within one LSB step per block;
  * acquisition with the composite BOC replica: the same detections,
    code phases and Doppler bins;
  * the ChannelManager with BocEngine (scan, and the fused twin for a
    short run) against gnsstpu's on one SV: the same slots, prompt streams
    within the tolerances above, Doppler within 0.05 Hz;
  * `python -m gnsstpu_torch track --signal galileo_e1b --device cpu`.
The CUDA kernel itself is compared with the twin by the test marked
`cuda` (skipped without a card) and by chip_smoke.py on the H100.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnsstpu.acquisition import search as jsearch
from gnsstpu.config import AcqConfig, ReceiverConfig, SignalConfig, TrackConfig
from gnsstpu.ops import nco as jnco
from gnsstpu.ops.boc import correlate_block_boc as j_correlate
from gnsstpu.runtime.manager import ChannelManager as JManager
from gnsstpu.runtime.sources import PackedArraySource as JPacked
from gnsstpu.runtime.telemetry import Telemetry as JTelemetry
from gnsstpu.signals import galileo_e1
from gnsstpu.sim import IFSimulator, SatParams
from gnsstpu.tracking import boc as jboc
from gnsstpu_torch.__main__ import main as cli_main
from gnsstpu_torch.acquisition import search as tsearch
from gnsstpu_torch.device import u32_numpy, u32_tensor
from gnsstpu_torch.ops import boc as tops
from gnsstpu_torch.ops import track_kernel as tk
from gnsstpu_torch.runtime.manager import ChannelManager as TManager
from gnsstpu_torch.runtime.sources import PackedArraySource as TPacked
from gnsstpu_torch.runtime.telemetry import Telemetry as TTelemetry
from gnsstpu_torch.tracking import boc as tboc
from gnsstpu_torch.tracking.engines import make_engine
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import to_port

SIG = SignalConfig(signal="galileo_e1b", if_freq=0.0, fs=4.2e6,
                   code_freq=galileo_e1.SUB_FREQ,
                   code_length=galileo_e1.SUB_LENGTH)
TRK = TrackConfig(dll_bw=1.0, el_spacing=0.25, pll_bw=15.0, fll_bw=50.0,
                  sll_bw=0.5, sll_spacing=0.25, aid_div=1540.0)
TSIG, TTRK = to_port(SIG), to_port(TRK)
CPU = torch.device("cpu")
PRNS = [11, 4]
SATS = [SatParams(prn=11, doppler_hz=510.0, code_phase_chips=3210.5,
                  cn0_dbhz=48.0,
                  nav_bits=np.random.default_rng(5).choice([-1.0, 1.0],
                                                           600)),
        SatParams(prn=4, doppler_hz=-800.0, code_phase_chips=100.25,
                  cn0_dbhz=48.0)]
ACC_ATOL = 8e-3
SPC = SIG.samples_per_code
BLKP = SPC + 2
BP = tk.plane_stride(BLKP)


def pad(c):
    return np.concatenate([c[-1:], c, c[:1]]).astype(np.float32)


@pytest.fixture(scope="module")
def chunk():
    return np.asarray(IFSimulator(SIG, SATS, noise_sigma=1.0,
                                  seed=4).generate(40))


@pytest.fixture(scope="module")
def handoff():
    """(code phase [samples], Doppler) per channel, 7 Hz off the truth."""
    spchip = SIG.fs / SIG.code_freq
    cp = np.array([int(round(s.code_phase_chips * spchip)) % SPC
                   for s in SATS])
    dp = np.array([s.doppler_hz + 7.0 for s in SATS], np.float32)
    cb = np.array([jnco.freq_to_step_u32(SIG.if_freq, SIG.fs)] * 2,
                  np.uint32)
    return cp, dp, cb


def _jstate(cp, dp):
    return jax.tree.map(jnp.asarray, jboc.BocTrackState.init(cp, dp))


def test_boc_fused_tables_identical():
    jc, js, jsc, jss = jboc.boc_fused_tables(SIG, TRK, PRNS)
    tc, ts, tsc, tss = tboc.boc_fused_tables(TSIG, TTRK, PRNS)
    assert (tsc, tss) == (jsc, jss) == (0.375, 1.25)
    assert BP == 16896 and BP % 128 == 0
    assert tc.shape == (2, 48, 3, BP) and ts.shape == (160, 3, BP)
    assert tc.dtype == ts.dtype == np.int8
    # Every tap the kernel can read, edge rows included, is the reference's
    # f32 value and exactly +-1, so int8 holds it; the padding is 0.
    for got, ref in ((tc, jc[:, :, :3, :BLKP]), (ts, js[:, :3, :BLKP])):
        assert set(np.unique(ref)) == {-1.0, 1.0}
        np.testing.assert_array_equal(got[..., :BLKP], ref)
        assert not got[..., BLKP:].any()
    np.testing.assert_array_equal(
        tboc.code_tap_rows(TSIG, TTRK, [4]), tc[1:])


def test_k2_twin_int8_tables_equal_f32_tables(chunk, handoff):
    """The narrowing changes no product: K2's plain twin on the int8
    padded tables equals, bit for bit, the twin on unpadded f32
    [.., blkp] tables."""
    cp, dp, cb = handoff
    tc, ts, _, _ = tboc.boc_fused_tables(TSIG, TTRK, PRNS)
    kw = tboc.boc_kernel_kwargs(TSIG, TTRK, n_blocks=6)
    outs = []
    for c, s in ((tc, ts), (tc[..., :BLKP].astype(np.float32),
                            ts[..., :BLKP].astype(np.float32))):
        args = tboc.boc_kernel_inputs(
            torch.tensor(chunk), torch.tensor(c), torch.tensor(s),
            u32_tensor(cb, CPU), tboc.BocTrackState.init(cp, dp, device=CPU),
            TTRK)
        outs.append(tk.track_chunk_boc_fused_ref(*args, **kw))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_correlate_block_matches_reference(chunk, handoff):
    cp, dp, cb = handoff
    kw = dict(code_spacing=0.25, sub_spacing=0.25, code_length=4092,
              sub_length=8184,
              base_code_step=float(np.float64(SIG.code_freq / 2.0) / SIG.fs),
              base_sub_step=float(np.float64(SIG.code_freq) / SIG.fs),
              inv_fs=1.0 / SIG.fs, blkmax=BLKP)
    codes = np.stack([pad(galileo_e1.primary_code(p)) for p in PRNS])
    sub = pad(galileo_e1.subcarrier())
    st = jboc.BocTrackState.init(cp, dp).corr
    st = st._replace(rem_code_phase=jnp.asarray([0.1, -0.05], jnp.float32),
                     rem_sub_phase=jnp.asarray([0.2, -0.3], jnp.float32))
    jout, jst = jax.vmap(
        lambda c, cbase, s: j_correlate(jnp.asarray(chunk), c,
                                        jnp.asarray(sub), cbase, s,
                                        **kw))(
        jnp.asarray(codes), jnp.asarray(cb), st)
    tst = tops.BocCorrState(*(torch.tensor(np.asarray(v)) for v in st))
    tst = tst._replace(carr_phase_u32=u32_tensor(np.asarray(
        st.carr_phase_u32), CPU), sample_pos=tst.sample_pos.to(torch.int32))
    tout, tnew = tops.correlate_block_boc(
        torch.tensor(chunk), torch.tensor(codes), torch.tensor(sub),
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


def test_scan_tracker_matches_reference(chunk, handoff):
    cp, dp, cb = handoff
    nb = 6
    codes = np.stack([pad(galileo_e1.primary_code(p)) for p in PRNS])
    sub = pad(galileo_e1.subcarrier())
    js, jo = jboc.make_boc_tracker(SIG, TRK, n_blocks=nb)(
        jnp.asarray(chunk), jnp.asarray(codes), jnp.asarray(sub),
        jnp.asarray(cb), _jstate(cp, dp))
    ts, to = tboc.make_boc_tracker(TSIG, TTRK, n_blocks=nb)(
        torch.tensor(chunk), torch.tensor(codes), torch.tensor(sub),
        u32_tensor(cb, CPU), tboc.BocTrackState.init(cp, dp, device=CPU))
    np.testing.assert_array_equal(to.acc.blksize.numpy(),
                                  np.asarray(jo.acc.blksize))
    np.testing.assert_array_equal(ts.corr.sample_pos.numpy(),
                                  np.asarray(js.corr.sample_pos))
    for name in to.acc._fields:
        np.testing.assert_allclose(getattr(to.acc, name).numpy(),
                                   np.asarray(getattr(jo.acc, name)),
                                   rtol=1e-5, atol=ACC_ATOL, err_msg=name)
    for name in to._fields[1:]:
        np.testing.assert_allclose(getattr(to, name).numpy(),
                                   np.asarray(getattr(jo, name)),
                                   rtol=1e-5, atol=1e-3, err_msg=name)


def test_k2_twin_matches_reference_kernel(chunk, handoff):
    cp, dp, cb = handoff
    nb = 6
    jc, js_, _, _ = jboc.boc_fused_tables(SIG, TRK, PRNS)
    ref = jboc.make_fused_boc_tracker(SIG, TRK, n_blocks=nb, interpret=True)
    rs, ro = ref(jnp.asarray(chunk), jnp.asarray(jc), jnp.asarray(js_),
                 jnp.asarray(cb), _jstate(cp, dp))
    tc, ts, _, _ = tboc.boc_fused_tables(TSIG, TTRK, PRNS)
    port = tboc.make_fused_boc_tracker(TSIG, TTRK, n_blocks=nb)
    before = tk.LAUNCHES["track_chunk_boc_fused"]
    gs, go = port(torch.tensor(chunk), torch.tensor(tc), torch.tensor(ts),
                  u32_tensor(cb, CPU),
                  tboc.BocTrackState.init(cp, dp, device=CPU))
    # The plain twin ran: no kernel launch was counted.
    assert tk.LAUNCHES["track_chunk_boc_fused"] == before
    np.testing.assert_array_equal(go.acc.blksize.numpy(),
                                  np.asarray(ro.acc.blksize))
    np.testing.assert_array_equal(gs.corr.sample_pos.numpy(),
                                  np.asarray(rs.corr.sample_pos))
    for name in go.acc._fields[:10]:
        np.testing.assert_allclose(getattr(go.acc, name).numpy(),
                                   np.asarray(getattr(ro.acc, name)),
                                   rtol=2e-3, atol=16.0, err_msg=name)
    np.testing.assert_allclose(go.carr_doppler.numpy(),
                               np.asarray(ro.carr_doppler), rtol=0,
                               atol=0.05)
    for name in ("rem_code_phase", "rem_sub_phase"):
        np.testing.assert_allclose(getattr(go.acc, name).numpy(),
                                   np.asarray(getattr(ro.acc, name)),
                                   rtol=0, atol=5e-4, err_msg=name)
    d = (u32_numpy(gs.corr.carr_phase_u32).astype(np.int64)
         - np.asarray(rs.corr.carr_phase_u32).astype(np.int64))
    d = (d + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert np.max(np.abs(d)) <= nb * BLKP


def test_k2_wrapper_refuses_other_devices():
    """The wrapper takes the plain twin for CPU tensors only; anything
    else must launch the kernel or raise, never run elsewhere."""
    C, blkp = 2, 64
    meta = torch.device("meta")
    args = (torch.empty((4096, 2), device=meta),
            torch.empty((C, 4, 3, blkp), device=meta),
            torch.empty((4, 3, blkp), device=meta),
            torch.empty((C,), dtype=torch.int32, device=meta),
            torch.empty((C, tk.NF), device=meta),
            torch.empty((C,), dtype=torch.int64, device=meta),
            torch.empty((C,), dtype=torch.int64, device=meta))
    with pytest.raises(ValueError, match="unsupported device"):
        tk.track_chunk_boc_fused(
            *args, n_blocks=1, blkp=blkp, code_length=4092,
            sub_length=8184, ph_code=64, ph_sub=64, span_code=0.375,
            span_sub=1.25, base_code_step=0.25, base_sub_step=0.5,
            fs=SIG.fs, coefs=(1.0,) * 7)


def test_engine_routing():
    cfg = ReceiverConfig(signal=SIG, track=TRK, n_channels=2)
    assert make_engine(to_port(cfg), "auto").name == "boc_fused"
    assert make_engine(to_port(cfg), "fused").name == "boc_fused"
    assert make_engine(to_port(cfg), "gather").name == "boc"
    eng = make_engine(to_port(cfg), "auto")
    assert (eng.period_ms, eng.spc) == (4, SPC)
    assert eng.rem_to_samples == SIG.fs / 1.023e6
    l3 = ReceiverConfig(signal=SignalConfig(signal="glonass_l3oc"))
    eng = make_engine(to_port(l3))
    assert type(eng).__name__ == "DualEngine" and eng.name == "dual_fused"


@pytest.fixture(scope="module")
def live_samples():
    return np.asarray(IFSimulator(SIG, SATS[:1], noise_sigma=1.0,
                                  seed=4).generate(1300))


def _acq():
    return AcqConfig(doppler_band=1000.0, coherent_ms=1, threshold=2.2,
                     doppler_step=125.0, prn_list=(11,))


def test_acquire_matches_reference(live_samples):
    acq = _acq()
    x = live_samples[:jsearch.acq_samples_needed(SIG, acq)]
    ref = jsearch.acquire(x, SIG, acq)
    got = tsearch.acquire(x, TSIG, to_port(acq), device="cpu")
    assert got.detected_prns() == ref.detected_prns() == [11]
    np.testing.assert_array_equal(got.code_phase, np.asarray(ref.code_phase))
    np.testing.assert_array_equal(got.carr_freq, ref.carr_freq)
    np.testing.assert_allclose(got.peak_metric, ref.peak_metric, rtol=1e-3)


@pytest.mark.parametrize("engine,n_ms", [("gather", 800), ("fused", 800)])
def test_manager_matches_reference(live_samples, engine, n_ms):
    cfg = ReceiverConfig(signal=SIG, acq=_acq(), track=TRK, n_channels=2)
    kw = dict(epoch_ms=400, reacq_period_ms=10 ** 9, confirm_epochs=3,
              sync_every=2, prefetch=True, readback="compact",
              engine=engine, prn_pool=[11, 20])
    jm = JManager(JPacked(live_samples, fmt="sm2"), cfg,
                  telemetry=JTelemetry(sink=io.StringIO()), **kw)
    jr = jm.run(n_ms)
    tm = TManager(TPacked(live_samples, fmt="sm2"), to_port(cfg),
                  device="cpu", telemetry=TTelemetry(sink=io.StringIO()),
                  **kw)
    tr = tm.run(n_ms)
    assert tm.engine == jm.engine == {"gather": "boc",
                                      "fused": "boc_fused"}[engine]
    assert len(tr) == len(jr) == n_ms // 400
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a.prn, b.prn)
        np.testing.assert_allclose(a.doppler_hz, b.doppler_hz, atol=0.05)
    assert ([(s.prn, s.state.value) for s in tm.slots]
            == [(s.prn, s.state.value) for s in jm.slots])
    assert tr[-1].prn[0] == 11
    assert abs(tr[-1].doppler_hz[0] - 510.0) < 5.0
    h, g = tm.prompt_stream(11), jm.prompt_stream(11)
    assert len(h["i_p"]) == len(g["i_p"]) == n_ms // 4
    for lane in ("i_p", "q_p"):
        # Compact readback: prompts ship as f16 (one step of 2^-10).
        np.testing.assert_allclose(h[lane], g[lane], rtol=2e-3, atol=16.0,
                                   err_msg=lane)
    np.testing.assert_allclose(h["carr_doppler"], g["carr_doppler"],
                               rtol=0, atol=0.05)
    np.testing.assert_array_equal(h["abs_sample"], g["abs_sample"])


def test_cli_tracks_galileo_file(live_samples, tmp_path, capsys):
    path = tmp_path / "gal.i8"
    np.clip(np.round(live_samples * 20.0), -127, 127).astype(
        np.int8).tofile(path)
    log = tmp_path / "tlm.jsonl"
    assert cli_main(["track", str(path), "--signal", "galileo_e1b",
                     "--device", "cpu", "--fs", "4.2e6", "--if-freq", "0",
                     "--ms", "1200", "--channels", "2", "--epoch-ms",
                     "400", "--band", "1000", "--coherent", "1",
                     "--threshold", "2.2", "--sync-every", "3",
                     "--log", str(log)]) == 0
    assert "live PRNs at end: [11]" in capsys.readouterr().out
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    starts = {r["prn"] for r in recs if r.get("what") == "channel_start"}
    assert starts == {11}
    health = [r for r in recs if r.get("type") == "task_health"
              and r.get("stage") == "track"]
    assert health and all(r["engine"] == "boc_fused" for r in health)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["twin", "repeat"])
@pytest.mark.parametrize("n_channels", [2, 48])
def test_cuda_k2_matches_plain_twin(cuda_device, chunk, handoff, case,
                                    n_channels):
    """'twin': the kernel against its plain twin; 'repeat': two launches
    on the same inputs are bit-identical (no atomics in the reduction).
    The two channels repeat to n_channels: 2 gives 8 CTAs per cluster and
    one 16-sample step per thread, 48 gives 2 CTAs and several steps."""
    reps = n_channels // len(PRNS)
    cp, dp, cb = (np.tile(a, reps) for a in handoff)
    nb = 6
    tc, ts, _, _ = tboc.boc_fused_tables(TSIG, TTRK, PRNS)
    tc = np.tile(tc, (reps, 1, 1, 1))
    port = tboc.make_fused_boc_tracker(TSIG, TTRK, n_blocks=nb)
    devs = (CPU, cuda_device) if case == "twin" else (cuda_device,) * 2
    res = []
    for dev in devs:
        before = tk.LAUNCHES["track_chunk_boc_fused"]
        st, out = port(torch.tensor(chunk, device=dev),
                       torch.tensor(tc, device=dev),
                       torch.tensor(ts, device=dev), u32_tensor(cb, dev),
                       tboc.BocTrackState.init(cp, dp, device=dev))
        assert tk.LAUNCHES["track_chunk_boc_fused"] == before + (
            dev.type == "cuda")
        res.append((st.corr.sample_pos.cpu(), [t.cpu() for t in out.acc]))
    (rpos, racc), (gpos, gacc) = res
    np.testing.assert_array_equal(gpos.numpy(), rpos.numpy())
    np.testing.assert_array_equal(gacc[10].numpy(), racc[10].numpy())
    for a, b in zip(gacc[:10], racc[:10]):
        if case == "repeat":
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                       atol=16.0)


def _fused_interpret(monkeypatch):
    """The reference's track_boc on its Pallas kernel in interpret mode
    (its fused engine asks for a TPU otherwise); gnsstpu is not edited."""
    import functools

    monkeypatch.setattr(jboc, "make_fused_boc_tracker", functools.partial(
        jboc.make_fused_boc_tracker, interpret=True))


@pytest.mark.parametrize("engine", ["gather", "fused"])
def test_track_boc_matches_reference(live_samples, engine, monkeypatch):
    """The offline driver of both packages over 60 code periods (240 ms)
    in chunks of 24 (three rebases): 'gather' against 'gather' with the
    scan tolerances above, the port's 'fused' (K2's plain twin) against
    the reference's Pallas kernel in interpret mode with K2's. Block
    geometry exact in both pairings; the f64 abs_sample exact for
    'gather', within 5e-4 chip after the port's half-slip term for
    'fused'."""
    from gnsstpu.runtime.sources import ArraySource as JArraySource
    from gnsstpu.tracking.driver import ChannelInit as JChannelInit
    from gnsstpu_torch.runtime.sources import ArraySource

    if engine == "fused":
        _fused_interpret(monkeypatch)
    n_blocks, chunk_blocks = 60, 24
    spchip = SIG.fs / SIG.code_freq
    s = SATS[0]
    chans = [JChannelInit(prn=s.prn, code_phase=int(round(
        s.code_phase_chips * spchip)) % SPC, doppler_hz=s.doppler_hz + 7.0)]
    ref = jboc.track_boc(JArraySource(live_samples), chans, SIG, TRK,
                         n_blocks, chunk_blocks=chunk_blocks,
                         code_mode=engine)
    before = tk.LAUNCHES["track_chunk_boc_fused"]
    got = tboc.track_boc(ArraySource(live_samples), [to_port(c)
                                                     for c in chans],
                         TSIG, TTRK, n_blocks, chunk_blocks=chunk_blocks,
                         code_mode=engine, device="cpu")
    assert tk.LAUNCHES["track_chunk_boc_fused"] == before
    assert got.i_pp.shape == (1, n_blocks)
    np.testing.assert_array_equal(got.prn, ref.prn)
    if engine == "gather":
        np.testing.assert_array_equal(got.abs_sample, ref.abs_sample)
    else:
        # The port's half-slip term (tracking.driver), which the
        # reference's drivers lack, at the nominal block length.
        from gnsstpu_torch.tracking.driver import replica_slip_samples
        slip = replica_slip_samples(
            ref.code_freq - SIG.code_freq / 2.0,
            np.full(ref.code_freq.shape, SPC), SIG.code_freq / 2.0)
        np.testing.assert_allclose(got.abs_sample, ref.abs_sample + slip,
                                   rtol=0,
                                   atol=5e-4 * SIG.fs / (SIG.code_freq / 2.0))
    rtol, atol = (1e-5, ACC_ATOL) if engine == "gather" else (2e-3, 16.0)
    for name in ("i_pp", "q_pp", "i_pe", "q_pe", "i_pl", "q_pl", "i_ep",
                 "q_ep", "i_lp", "q_lp"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=rtol, atol=atol, err_msg=name)
    dtol = 1e-3 if engine == "gather" else 0.05
    for name in ("carr_freq", "code_freq", "sub_freq"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=0, atol=dtol, err_msg=name)
    assert abs(got.carr_freq[0, -10:].mean() - 510.0) < 5.0
