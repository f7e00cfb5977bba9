"""The live receiver's per-epoch lock summary and readback packing
(gnsstpu_torch/ops/summary_kernel.py, csrc/epoch_summary.cu).

CPU tests: the superepoch buffer filled slot by slot holds the bytes of
the stack / cat the manager built before (the old code is kept here as
the reference of that layout), ChannelManager._decode_readback reads them
back, and the wrapper's checks. Card tests (marker cuda): the kernel
against its plain version on CUDA tensors, and the manager's summary path
on the card. This file imports neither jax nor gnsstpu, so on the card
(whose host lacks jax, which tests/conftest.py imports):
    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_summary.py
"""

import numpy as np
import pytest
import torch

from gnsstpu_torch.ops import summary_kernel as sk
from gnsstpu_torch.runtime.manager import ChannelManager
from gnsstpu_torch.tracking import lock as tlock
from gnsstpu_torch.tracking.engines import EpochObs

SPC = 2048                  # GPS L1 C/A at 2.048 Msps: samples a block
T_INT = 1e-3
CN0_DROP = 32.0
K = 8                       # epochs a superepoch, as the live GPS path
# Stats tolerances of the kernel against its plain version (only the
# order of the sums differs): C/N0 in dB, PLL and code lock absolute.
CN0_TOL, LOCK_TOL = 1e-3, 1e-5
KW = dict(t_int_s=T_INT, cn0_drop_dbhz=CN0_DROP, spc=SPC)


def synth_obs(E: int, C: int, *, dual: bool = False, strided: bool = True,
              seed: int = 0, zero=(), device="cpu") -> EpochObs:
    """One epoch's observables: channel amplitudes from noise alone to
    strong, 20-block data bits, rem over [0, 1) with the u16 edges (0,
    the i16 wrap at 32768, 1.0), blksize around SPC. strided: [E, C]
    lanes of one [E, C, 16] output, as K1 returns them; else contiguous,
    as the scan engines do. zero: channels whose correlators are all 0
    (the clamps)."""
    rng = np.random.default_rng(seed)
    amp = np.linspace(0.0, 4000.0, C)
    bits = rng.choice([-1.0, 1.0], (E // 20 + 1, C)).repeat(20, 0)[:E]

    def noise():
        return rng.normal(0.0, 250.0, (E, C))

    ip = amp * bits + noise()
    lanes = {"ip": ip, "qp": 0.05 * amp * bits + noise(),
             "ie": 0.5 * ip + noise(), "qe": noise(),
             "il": 0.5 * ip + noise(), "ql": noise(),
             "dopp": rng.uniform(-5e3, 5e3, (E, C))}
    if dual:
        lanes["ip2"] = 0.8 * amp * bits[::-1] + noise()
        lanes["qp2"] = noise()
    rem = rng.uniform(0.0, 1.0, (E, C))
    edges = [0.0, 32767.0 / 65535, 32767.5 / 65535, 32768.0 / 65535, 1.0,
             0.5 / 65535]
    rem.flat[:len(edges)] = edges
    lanes["rem"] = rem
    blk = SPC + rng.integers(-3, 4, (E, C))
    for name in ("ip", "qp", "ie", "qe", "il", "ql", "ip2", "qp2"):
        if name in lanes:
            lanes[name][:, list(zero)] = 0.0
    if strided:
        out = torch.zeros((E, C, 16), dtype=torch.float32)
        order = ("ie", "qe", "ip", "qp", "il", "ql", "dopp", "ip2", "rem",
                 "blk", "qp2")
        lanes["blk"] = blk
        for i, name in enumerate(order):
            if name in lanes:
                out[:, :, i] = torch.as_tensor(lanes[name])
        out = out.to(device)
        views = {n: out[:, :, i] for i, n in enumerate(order)
                 if n in lanes}
        views["blksize"] = views.pop("blk").to(torch.int32)
    else:
        views = {n: torch.as_tensor(v, dtype=torch.float32, device=device)
                 for n, v in lanes.items()}
        views["blksize"] = torch.as_tensor(blk, dtype=torch.int32,
                                           device=device)
    return EpochObs(**views)


def _old_pack(summaries, compact: bool) -> list:
    """The manager's _pack_epochs before the kernel (verbatim): the
    stack of K summaries and, compact, the cat of their bytes."""
    leaves = [torch.stack(xs) for xs in zip(*summaries)]
    if not compact:
        return leaves
    pp, rem, blkd, dopp, st = leaves
    rem16 = torch.where(rem >= 32768, rem - 65536, rem).to(torch.int16)
    return [torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                       for t in (pp, rem16, blkd, dopp, st)])]


def _decoder(E: int, C: int, dual: bool, compact: bool) -> ChannelManager:
    """A ChannelManager with just what _decode_readback reads."""
    from types import SimpleNamespace

    mgr = ChannelManager.__new__(ChannelManager)
    mgr.readback = "compact" if compact else "f32"
    mgr.eng = SimpleNamespace(has_data_component=dual)
    mgr._bpe = E
    mgr.cfg = SimpleNamespace(n_channels=C)
    mgr.sig = SimpleNamespace(samples_per_code=SPC)
    return mgr


CASES = [(mode, dual, strided) for mode in ("compact", "f32")
         for dual in (False, True) for strided in (True, False)]
CASE_IDS = [f"{mode}-{'dual' if dual else 'single'}-"
            f"{'strided' if strided else 'contiguous'}"
            for mode, dual, strided in CASES]


@pytest.mark.parametrize("mode,dual,strided", CASES, ids=CASE_IDS)
def test_slot_fill_matches_stack_cat(mode, dual, strided):
    """8 epochs (E = 45 blocks, so NWPR leaves a 5-block tail, C = 5 with
    a zero channel) written slot by slot into new_readback's buffer give
    the bytes of summary_plain's per-epoch lanes stacked (and, compact,
    cat) as the old _pack_epochs did; _decode_readback reads both to the
    same streams and stats."""
    E, C, m = 45, 5, 20
    compact = mode == "compact"
    obs = [synth_obs(E, C, dual=dual, strided=strided, seed=j, zero=(1,))
           for j in range(K)]
    out = sk.new_readback(K, E, C, dual=dual, compact=compact,
                          device="cpu")
    for j, o in enumerate(obs):
        assert sk.epoch_summary(o, out, j, m=m, **KW) is False
    want = _old_pack([sk.summary_plain(o, compact=compact, m=m, **KW)
                      for o in obs], compact)
    assert len(out) == len(want)
    for got, ref in zip(out, want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.equal(got, ref)

    mgr = _decoder(E, C, dual, compact)
    streams, stats = mgr._decode_readback([t.numpy() for t in out])
    rstreams, rstats = mgr._decode_readback([t.numpy() for t in want])
    np.testing.assert_array_equal(streams, rstreams)
    np.testing.assert_array_equal(stats, rstats)
    assert streams.shape == (K, E, C, 7 if dual else 5)
    # What comes back is the epoch's own observables and lock stats.
    ref = tlock.assess_device(obs[3].ie, obs[3].qe, obs[3].ip, obs[3].qp,
                              obs[3].il, obs[3].ql, t_int_s=T_INT,
                              cn0_drop_dbhz=CN0_DROP, m=m)
    np.testing.assert_array_equal(stats[3, :, 0], ref["cn0_dbhz"].numpy())
    np.testing.assert_array_equal(stats[3, :, 3],
                                  ref["locked"].numpy().astype(np.float32))
    np.testing.assert_array_equal(streams[3, ..., ChannelManager._S_BLK],
                                  obs[3].blksize.numpy())
    np.testing.assert_array_equal(streams[3, ..., ChannelManager._S_DOPP],
                                  obs[3].dopp.numpy())
    ip = streams[3, ..., ChannelManager._S_IP]
    if compact:      # f16 of ip / SPC: half an ulp, or a subnormal's
        np.testing.assert_allclose(ip, obs[3].ip.numpy(), rtol=2.0 ** -11,
                                   atol=2.0 ** -25 * SPC)
    else:
        np.testing.assert_array_equal(ip, obs[3].ip.numpy())


def test_readback_buffer_layout():
    """new_readback: compact is one uint8 buffer of compact_sizes' bytes
    per epoch; f32 is (streams, stats), views of one buffer;
    compact_views cuts the regions at the decode's offsets."""
    E, C = 40, 3
    for dual in (False, True):
        (buf,) = sk.new_readback(K, E, C, dual=dual, compact=True,
                                 device="cpu")
        P = 4 if dual else 2
        assert buf.dtype == torch.uint8 and buf.numel() == K * (
            E * C * (2 * P + 2 + 2 + 4) + C * 16)
        views = sk.compact_views(buf, K, E, C, dual)
        assert [v.shape for v in views] == [
            (K, E, C, P), (K, E, C), (K, E, C), (K, E, C), (K, C, 4)]
        assert all(v.untyped_storage().data_ptr()
                   == buf.untyped_storage().data_ptr() for v in views)
        streams, stats = sk.new_readback(K, E, C, dual=dual, compact=False,
                                         device="cpu")
        assert streams.shape == (K, E, C, 7 if dual else 5)
        assert stats.shape == (K, C, 4)
        assert (streams.untyped_storage().data_ptr()
                == stats.untyped_storage().data_ptr())


def _bad(case: str):
    """(obs, out, k, expected exception) for one wrong argument."""
    E, C = 40, 3
    obs = synth_obs(E, C)
    out = sk.new_readback(K, E, C, dual=False, compact=True, device="cpu")
    if case == "ip_dtype":
        return obs._replace(ip=obs.ip.double()), out, 0, TypeError
    if case == "blksize_dtype":
        return obs._replace(blksize=obs.blksize.long()), out, 0, TypeError
    if case == "qp_shape":
        return obs._replace(qp=torch.zeros(E, C + 1)), out, 0, ValueError
    if case == "readback_size":
        return obs, [out[0][:-1]], 0, ValueError
    if case == "readback_dtype":
        return obs, [out[0].view(torch.int8)], 0, TypeError
    if case == "stats_shape":
        streams, stats = sk.new_readback(K, E, C, dual=False, compact=False,
                                         device="cpu")
        return obs, [streams, stats[:, :2]], 0, ValueError
    if case == "mixed_obs_devices":
        return obs._replace(dopp=obs.dopp.to("meta")), out, 0, ValueError
    if case == "mixed_readback_device":
        return obs, [out[0].to("meta")], 0, ValueError
    if case == "data_prompt_alone":
        return obs._replace(ip2=obs.ip), out, 0, ValueError
    if case == "slot":
        return obs, out, K, ValueError
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "ip_dtype", "blksize_dtype", "qp_shape", "readback_size",
    "readback_dtype", "stats_shape", "mixed_obs_devices",
    "mixed_readback_device", "data_prompt_alone", "slot"])
def test_wrapper_raises(case):
    obs, out, k, exc = _bad(case)
    before = sk.LAUNCHES["epoch_summary"]
    with pytest.raises(exc):
        sk.epoch_summary(obs, out, k, m=20, **KW)
    assert sk.LAUNCHES["epoch_summary"] == before


def test_cpu_runs_plain_and_counts_no_launch():
    """CPU tensors take the plain version: False, no launch counted, and
    slot k holds fill_plain's bytes."""
    E, C = 40, 4
    obs = synth_obs(E, C, seed=7)
    before = sk.LAUNCHES["epoch_summary"]
    out = sk.new_readback(2, E, C, dual=False, compact=True, device="cpu")
    ref = [torch.zeros_like(out[0])]
    assert sk.epoch_summary(obs, out, 1, m=20, **KW) is False
    sk.fill_plain(obs, ref, 1, m=20, **KW)
    views = sk.compact_views(out[0], 2, E, C, False)
    rviews = sk.compact_views(ref[0], 2, E, C, False)
    assert all(torch.equal(v[1], r[1]) for v, r in zip(views, rviews))
    assert sk.LAUNCHES["epoch_summary"] == before


def test_reset_launches_zeroes_summary_count(monkeypatch):
    """track_kernel.reset_launches zeroes the summary kernel's count with
    K1-K3's, so a path's counts start together."""
    from gnsstpu_torch.ops import track_kernel as tk

    monkeypatch.setitem(sk.LAUNCHES, "epoch_summary", 7)
    monkeypatch.setitem(tk.LAUNCHES, "track_chunk_fused", 7)
    tk.reset_launches()
    assert sk.LAUNCHES == {"epoch_summary": 0}
    assert set(tk.LAUNCHES.values()) == {0}


# --- on the card -----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run "
                    "on the card with pytest --noconftest -m cuda "
                    "tests/test_torch_summary.py")
    return torch.device("cuda", 0)


def _k1_obs(dev, n: int) -> list:
    """n epochs of K1's own output (E = 500 blocks, C = 12 channels, the
    strided lanes of out [E, C, 16]) over bench_tracking's 12 satellites,
    all in the signal, each launch after the last on the same chunk."""
    from gnsstpu_torch import bench as gb
    from gnsstpu_torch.sim import IFSimulator

    E = 500
    sats = gb.tracking_sky(12)
    samples = IFSimulator(gb.GPS_SIG, sats, noise_sigma=1.0, seed=2,
                          device=dev).generate(E + 3)
    st = gb.tracking_setup(gb.GPS_SIG, gb.GPS_TRK, 12, E, dev,
                           samples=samples)
    state, obs = st.state0, []
    for _ in range(n):
        state, out = st.tracker(st.chunk, st.tab, st.consts,
                                gb.rebase(state))
        obs.append(EpochObs(ip=out.ip, qp=out.qp, ie=out.ie, qe=out.qe,
                            il=out.il, ql=out.ql, rem=out.rem_code_phase,
                            blksize=out.blksize, dopp=out.carr_doppler))
    assert obs[0].ip.stride() == (12 * 16, 16)
    return obs


def _card_obs(case: str, dev) -> list:
    if case == "k1_out":
        return _k1_obs(dev, K)
    E, C, kw = {"scan_contiguous": (500, 12, dict(strided=False)),
                "e125": (125, 12, {}),
                "dual": (500, 12, dict(dual=True)),
                "zero_prompts": (500, 12, dict(zero=(0, 5, 11)))}[case]
    return [synth_obs(E, C, seed=100 + j, device=dev, **kw)
            for j in range(K)]


def _split(out: list, E: int, C: int, dual: bool) -> tuple:
    """(stream lanes as bytes, stats [K, C, 4]) of a readback on the
    host."""
    if len(out) == 1:
        st = sk.compact_views(out[0], K, E, C, dual)[4]
        n_streams = out[0].numel() - st.numel() * 4
        return out[0][:n_streams].cpu(), st.cpu()
    return out[0].cpu().view(torch.uint8), out[1].cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["compact", "f32"])
@pytest.mark.parametrize("case", ["k1_out", "scan_contiguous", "e125",
                                  "dual", "zero_prompts"])
def test_card_kernel_matches_plain(card, case, mode):
    """The kernel against its plain version on the same CUDA tensors, 8
    epochs into one readback: stream lanes bit-equal, stats within
    CN0_TOL / LOCK_TOL (the sums' order), locked equal wherever C/N0 and
    the PLL lock are that far from their thresholds; a second launch on
    the same inputs is bit-identical; one launch counted an epoch."""
    obs = _card_obs(case, card)
    E, C = obs[0].ip.shape
    dual = obs[0].ip2 is not None
    compact = mode == "compact"
    m = min(20, E)
    res = []
    for run in ("kernel", "plain", "kernel"):
        out = sk.new_readback(K, E, C, dual=dual, compact=compact,
                              device=card)
        for j, o in enumerate(obs):
            if run == "kernel":
                before = sk.LAUNCHES["epoch_summary"]
                assert sk.epoch_summary(o, out, j, m=m, **KW) is True
                assert sk.LAUNCHES["epoch_summary"] == before + 1
            else:
                sk.fill_plain(o, out, j, m=m, **KW)
        torch.cuda.synchronize(card)
        res.append(_split(out, E, C, dual))
    (ks, kst), (ps, pst), (ks2, kst2) = res
    assert torch.equal(ks, ps), "stream lanes differ from the plain version"
    assert torch.equal(ks2, ks) and torch.equal(kst2, kst)
    got, want = kst.numpy(), pst.numpy()
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0,
                               atol=CN0_TOL)
    np.testing.assert_allclose(got[..., 1:3], want[..., 1:3], rtol=0,
                               atol=LOCK_TOL)
    away = ((np.abs(want[..., 0] - CN0_DROP) > CN0_TOL)
            & (np.abs(want[..., 1] - 0.5) > LOCK_TOL))
    np.testing.assert_array_equal(got[..., 3][away], want[..., 3][away])
    if case == "zero_prompts":
        z = [0, 5, 11]
        assert np.all(want[:, z, 1] == 0.0) and np.all(got[:, z, 1] == 0.0)
        np.testing.assert_array_equal(got[:, z, 0], want[:, z, 0])


@pytest.mark.cuda
def test_card_manager_path(card):
    """Two superepochs (8 epochs of 500 ms each) of the live GPS
    receiver's ChannelManager on the card (K1, compact readback,
    prefetch): one summary launch per K1 launch, the dispatch spans'
    `summaries` counters sum to them, and the summary path dispatches no
    PyTorch op but each superepoch's one torch.empty."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from gnsstpu_torch import bench as gb
    from gnsstpu_torch.ops import track_kernel as tk
    from gnsstpu_torch.runtime.sources import PackedArraySource
    from gnsstpu_torch.runtime.telemetry import Telemetry
    from gnsstpu_torch.sim import IFSimulator

    sats, prns, _, absent = gb.gps_sky()
    buf = IFSimulator(gb.GPS_SIG, sats, noise_sigma=1.0, seed=3,
                      device=card).generate(2 * 4000 + 800)
    src = PackedArraySource(buf, fmt="sm2", scale=1.0)
    pool = prns + absent
    tlm = Telemetry(sink=None, trace=True)
    mgr = gb.gps_manager(src, gb.gps_config(pool), pool, device=card,
                         telemetry=tlm, navigator=None)
    ops = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func))
            return func(*args, **(kwargs or {}))

    def counted(fn):
        def run(*args):
            with Ops():
                return fn(*args)
        return run

    mgr._summarize = counted(mgr._summarize)
    mgr._new_readback = counted(mgr._new_readback)
    k1_0 = tk.LAUNCHES["track_chunk_fused"]
    sum_0 = sk.LAUNCHES["epoch_summary"]
    mgr.run(2 * 4000)
    torch.cuda.synchronize(card)
    k1 = tk.LAUNCHES["track_chunk_fused"] - k1_0
    launches = sk.LAUNCHES["epoch_summary"] - sum_0
    disp = [s for s in tlm.spans if s["name"] == "dispatch"]
    assert k1 >= 2 * K and launches == k1
    assert sum(s["counters"].get("summaries", 0) for s in disp) == launches
    assert ops == ["aten.empty.memory_format"] * len(disp)
    assert any(r.prn.any() for r in mgr.records)
