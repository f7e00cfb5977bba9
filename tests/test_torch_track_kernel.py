"""Port fused K1 tracker vs gnsstpu's fused Pallas tracker (interpret mode).

On the CPU the port's wrapper runs K1's plain PyTorch twin; the reference
runs its Pallas kernel in interpret mode, as tests/test_track_kernel.py
does. Same inputs (JAX IFSimulator on the CPU, numpy tables and state),
held to test_track_kernel.py's tolerances: block geometry and cursors
exact, accumulators rtol 2e-3 / atol 2, carrier Doppler 0.05 Hz, code
remainder 5e-4 chip, carrier phase within one LSB step flip per block.

K1's tap table is int8 (fused_tap_rows): the reference's +-1 rows on
lanes [0, blkp), zeros up to plane_stride(blkp). K1 is held to the
reference at GPS L1 C/A 2.048 Msps and at BeiDou B1I 4.096 Msps, whose
4,098-sample blocks the first CUDA K1 refused. Its 'atan' FLL (BeiDou's
live loop; the reference's kernel has 'atan2' only) is checked to ignore
whole-block sign flips.

K2's and K3's cluster split (cluster_split) is checked here for the
channel counts and block lengths the port runs and beyond.

The CUDA kernel itself is compared with the twin by the tests marked
`cuda` (skipped without a card) and by chip_smoke.py on the H100.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnsstpu.config import SignalConfig, TrackConfig
from gnsstpu.sim import IFSimulator, SatParams
from gnsstpu.tracking import scan as jscan
from gnsstpu.tracking.fused import fused_code_table as j_fused_code_table
from gnsstpu.tracking.fused import make_fused_tracker as j_make_fused
from gnsstpu_torch.device import u32_numpy, u32_tensor
from gnsstpu_torch.ops import track_kernel as tk
from gnsstpu_torch.tracking import fused as tfused
from gnsstpu_torch.tracking import scan as tscan
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import to_port

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
TRK = TrackConfig(dll_bw=1.0, el_spacing=0.3)
TSIG, TTRK = to_port(SIG), to_port(TRK)
# BeiDou B1I live (tests/test_live_families.py): blkp 4,098.
BSIG = SignalConfig(signal="beidou_b1i", if_freq=0.0, fs=4.096e6,
                    code_freq=2.046e6, code_length=2046, complex_iq=True)
BTRK = TrackConfig(dll_bw=1.5, pll_bw=25.0, fll_bw=150.0,
                   aid_div=1561.098e6 / 2.046e6)
CPU = torch.device("cpu")
ACCS = ("ie", "qe", "ip", "qp", "il", "ql")


def _setup(C, n_blocks, sig=SIG, trk=TRK):
    prns = [3, 9, 17, 25, 5, 12, 22, 28, 31, 7][:C]
    sats = [SatParams(prn=p, doppler_hz=400.0 * i - 600.0,
                      code_phase_chips=50.0 * i + 11.0, cn0_dbhz=49.0)
            for i, p in enumerate(prns)]
    chunk = np.asarray(IFSimulator(sig, sats, noise_sigma=1.0,
                                   seed=4).generate(n_blocks + 3))
    tab = j_fused_code_table(sig, trk, prns)
    cb, ia = jscan.channel_consts(sig, trk, prns)
    spchip = sig.fs / sig.code_freq
    cp = np.array([int(round(s.code_phase_chips * spchip)) for s in sats])
    dp = np.array([s.doppler_hz + 37.0 for s in sats], np.float32)
    return prns, chunk, tab, cb, ia, cp, dp


def _compare(got_state, got_out, ref_state, ref_out, n_blocks, sig=SIG):
    np.testing.assert_array_equal(got_out.blksize.numpy(),
                                  np.asarray(ref_out.blksize))
    np.testing.assert_array_equal(got_state.corr.sample_pos.numpy(),
                                  np.asarray(ref_state.corr.sample_pos))
    d = (u32_numpy(got_state.corr.carr_phase_u32).astype(np.int64)
         - np.asarray(ref_state.corr.carr_phase_u32).astype(np.int64))
    d = (d + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert np.max(np.abs(d)) <= 4 * n_blocks * (sig.samples_per_code + 2)
    for name in ACCS:
        np.testing.assert_allclose(getattr(got_out, name).numpy(),
                                   np.asarray(getattr(ref_out, name)),
                                   rtol=2e-3, atol=2.0, err_msg=name)
    np.testing.assert_allclose(got_out.carr_doppler.numpy(),
                               np.asarray(ref_out.carr_doppler),
                               rtol=0, atol=0.05)
    np.testing.assert_allclose(got_out.rem_code_phase.numpy(),
                               np.asarray(ref_out.rem_code_phase),
                               rtol=0, atol=5e-4)


def _port_vs_reference(C, n_blocks, sig, trk):
    """The port's fused tracker on K1's int8 rows (the plain twin on the
    CPU) against the reference's Pallas kernel in interpret mode."""
    prns, chunk, tab, cb, ia, cp, dp = _setup(C, n_blocks, sig, trk)
    st0 = jax.tree.map(jnp.asarray, jscan.TrackState.init(cp, dp))
    ref = j_make_fused(sig, trk, n_blocks=n_blocks, interpret=True)
    ref_state, ref_out = ref(jnp.asarray(chunk), jnp.asarray(tab),
                             (jnp.asarray(cb), jnp.asarray(ia)), st0)

    tsig, ttrk = to_port(sig), to_port(trk)
    np.testing.assert_array_equal(tfused.fused_code_table(tsig, ttrk, prns),
                                  tab)
    rows = tfused.fused_tap_rows(tfused.fused_code_table(tsig, ttrk, prns))
    port = tfused.make_fused_tracker(tsig, ttrk, n_blocks=n_blocks)
    before = tk.LAUNCHES["track_chunk_fused"]
    got_state, got_out = port(
        torch.tensor(chunk), torch.tensor(rows),
        (u32_tensor(cb, CPU), torch.tensor(ia)),
        tscan.TrackState.init(cp, dp, device=CPU))
    # The plain twin ran: no kernel launch was counted.
    assert tk.LAUNCHES["track_chunk_fused"] == before
    _compare(got_state, got_out, ref_state, ref_out, n_blocks, sig)


@pytest.mark.parametrize("C,n_blocks", [(4, 12), (9, 6)])
def test_port_fused_matches_reference_fused(C, n_blocks):
    _port_vs_reference(C, n_blocks, SIG, TRK)


def test_port_fused_matches_reference_beidou_4096():
    """BeiDou B1I at 4.096 Msps: 4,098-sample blocks."""
    assert BSIG.samples_per_code + 2 == 4098
    _port_vs_reference(2, 4, BSIG, BTRK)


def _flip_blocks(chunk, cp, blksize, sign):
    """chunk with each tracked block (from sample cp on) times its sign."""
    starts = cp + np.concatenate([[0], np.cumsum(blksize)[:-1]])
    out = chunk.copy()
    for s0, n, s in zip(starts, blksize, sign):
        out[s0:s0 + n] *= s
    return out


@pytest.mark.parametrize("flips", [False, True])
def test_k1_atan_fll_matches_reference_scan(flips):
    """K1's 'atan' FLL (the live BeiDou loop's) against the reference's
    scan tracker in table mode (gnsstpu/tracking/scan.py, the engine whose
    1/64-chip rows K1 shares), at BeiDou B1I 4.096 Msps, on the plain
    signal and with whole blocks negated as NH(20) does:
    test_track_kernel.py's fused-vs-scan tolerances."""
    from gnsstpu.ops import code_tables as jtables

    n_blocks = 8
    trk = dataclasses.replace(BTRK, fll_disc="atan")
    prns, chunk, tab, cb, ia, cp, dp = _setup(2, n_blocks, BSIG, trk)
    spc = BSIG.samples_per_code
    rows = jtables.phase_row_table(BSIG.signal, BSIG.fs, BSIG.code_freq,
                                   BSIG.code_length, spc + 2)
    codes = jnp.asarray(np.stack([rows[p - 1] for p in prns]))
    ref = jscan.make_tracker(BSIG, trk, n_blocks=n_blocks, code_mode="table")
    consts = (jnp.asarray(cb), jnp.asarray(ia))

    def run_ref(x):
        st0 = jax.tree.map(jnp.asarray, jscan.TrackState.init(cp, dp))
        return ref(jnp.asarray(x), codes, consts, st0)

    if flips:
        # Both channels' blocks share one length here; flip on channel 0's.
        blk = np.asarray(run_ref(chunk)[1].blksize)[:, 0]
        sign = np.array([1, -1, -1, 1, -1, 1, 1, -1], np.float32)
        chunk = _flip_blocks(chunk, cp[0], blk, sign)
    ref_state, ref_out = run_ref(chunk)
    port = tfused.make_fused_tracker(to_port(BSIG), to_port(trk),
                                     n_blocks=n_blocks)
    got_state, got_out = port(
        torch.tensor(chunk), torch.tensor(tfused.fused_tap_rows(tab)),
        (u32_tensor(cb, CPU), torch.tensor(ia)),
        tscan.TrackState.init(cp, dp, device=CPU))
    _compare(got_state, got_out, ref_state, ref_out, n_blocks, BSIG)


@pytest.mark.parametrize("fll_disc", ["atan", "atan2"])
def test_k1_atan_fll_ignores_block_sign_flips(fll_disc):
    """BeiDou D1's NH(20) code flips the symbol between 1 ms blocks. With
    fll_disc 'atan' (the live BeiDou loop's) K1's loop is blind to such
    flips: with whole blocks of the signal negated, every loop output is
    bit-identical and the accumulators only change sign. The
    four-quadrant 'atan2' FLL, the only one the reference's kernel has,
    reads each flip as a frequency error and its loop moves."""
    n_blocks = 8
    trk = to_port(TrackConfig(dll_bw=1.5, pll_bw=25.0, fll_bw=150.0,
                              fll_disc=fll_disc,
                              aid_div=1561.098e6 / 2.046e6))
    prns, chunk, tab, cb, ia, cp, dp = _setup(1, n_blocks, BSIG, BTRK)
    kw = tfused.kernel_kwargs(to_port(BSIG), trk, n_blocks=n_blocks)
    assert kw["fll_disc"] == fll_disc
    rows = torch.tensor(tfused.fused_tap_rows(tab))
    consts = (u32_tensor(cb, CPU), torch.tensor(ia))

    def run(x):
        st0 = tscan.TrackState.init(cp, dp, device=CPU)
        return tk.track_chunk_fused(*tfused.kernel_inputs(
            torch.tensor(x), rows, consts, st0), **kw)[0].numpy()

    out = run(chunk)
    sign = np.array([1, -1, -1, 1, -1, 1, 1, -1], np.float32)
    got = run(_flip_blocks(chunk, cp[0],
                           out[:, 0, tk.O_BLKSIZE].astype(np.int64), sign))
    accs = [tk.O_IE, tk.O_QE, tk.O_IP, tk.O_QP, tk.O_IL, tk.O_QL]
    loop = [j for j in range(tk.NOUT) if j not in accs]
    if fll_disc == "atan":
        np.testing.assert_array_equal(got[..., loop], out[..., loop])
        np.testing.assert_array_equal(got[..., accs],
                                      sign[:, None, None] * out[..., accs])
    else:
        assert np.any(got[:, 0, tk.O_CARR_DOPPLER]
                      != out[:, 0, tk.O_CARR_DOPPLER])


@pytest.mark.parametrize("sig,trk", [(SIG, TRK), (BSIG, BTRK)])
def test_fused_tap_rows_are_the_reference_table_in_int8(sig, trk):
    prns = [3, 17, 30]
    ref = j_fused_code_table(sig, trk, prns)
    blkp = sig.samples_per_code + 2
    rows = tfused.fused_tap_rows(
        tfused.fused_code_table(to_port(sig), to_port(trk), prns))
    assert rows.dtype == np.int8
    assert rows.shape == ref.shape[:2] + (tk.plane_stride(blkp),)
    assert rows.shape[-1] % 128 == 0
    np.testing.assert_array_equal(rows[..., :blkp], ref)
    assert set(np.unique(rows[..., :blkp])) == {-1, 1}
    assert not rows[..., blkp:].any()


def _meta_args(C, R, lanes, dtype):
    meta = torch.device("meta")
    return (torch.empty((4096, 2), device=meta),
            torch.empty((C, R, lanes), dtype=dtype, device=meta),
            torch.empty((C,), dtype=torch.int32, device=meta),
            torch.empty((C, tk.NF), device=meta),
            torch.empty((C,), dtype=torch.int64, device=meta),
            torch.empty((C,), dtype=torch.int64, device=meta))


def _fused_kw(blkp):
    return dict(n_blocks=1, blkp=blkp, code_length=1023, phases_per_chip=64,
                spacing=0.3, span_chips=1.0, base_code_step=0.5, fs=SIG.fs,
                coefs=(1.0,) * 5)


def test_wrapper_refuses_other_devices():
    """The wrapper takes the plain twin for CPU tensors only; anything
    else must launch the kernel or raise, never run elsewhere."""
    C, blkp = 2, SIG.samples_per_code + 2
    args = _meta_args(C, 128, tk.plane_stride(blkp), torch.int8)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.track_chunk_fused(*args, **_fused_kw(blkp))


@pytest.mark.parametrize("blkp,lanes,dtype,err,match", [
    (tk.MAX_BLKP + 1, tk.plane_stride(tk.MAX_BLKP + 1), torch.int8,
     ValueError, "MAX_BLKP = 32768"),
    (2050, 2050, torch.float32, TypeError, "tab dtype"),
    (2050, 2050, torch.int8, ValueError, "tab shape"),
])
def test_wrapper_refuses_what_k1_does_not_take(blkp, lanes, dtype, err,
                                               match):
    """Blocks past MAX_BLKP, f32 tables and unpadded rows raise before any
    launch, on every device."""
    with pytest.raises(err, match=match):
        tk.track_chunk_fused(*_meta_args(2, 128, lanes, dtype),
                             **_fused_kw(blkp))


def test_engine_banks():
    """The fused engine's slot bank holds K1's int8 rows [C, R, bp]; the
    gather and table engines keep f32 codes."""
    from gnsstpu.config import ReceiverConfig
    from gnsstpu_torch.tracking.engines import ScanFamilyEngine

    cfg = to_port(ReceiverConfig(signal=SIG, track=TRK, n_channels=3))
    blkp = SIG.samples_per_code + 2
    shapes = {"fused": (3, 128, tk.plane_stride(blkp)),
              "table": (3, 256, blkp), "gather": (3, 1025)}
    for mode, shape in shapes.items():
        eng = ScanFamilyEngine(cfg, mode)
        bank = eng.new_bank(3)
        eng.write_slot(bank, 1, 17)
        assert bank["codes"].shape == shape, mode
        assert bank["codes"].dtype == (np.int8 if mode == "fused"
                                       else np.float32), mode
        assert set(np.unique(bank["codes"][1])) <= {-1, 0, 1}
    ref = j_fused_code_table(SIG, TRK, [17])[0]
    fused = ScanFamilyEngine(cfg, "fused")
    bank = fused.new_bank(2)
    fused.write_slot(bank, 0, 17)
    np.testing.assert_array_equal(bank["codes"][0, :, :blkp], ref)


@pytest.mark.parametrize("blkp", [16802, 24002])
@pytest.mark.parametrize("C", [1, 3, 12, 48, 132, 200])
def test_cluster_split_covers_the_block(C, blkp):
    """K2's (16,802 at 4.2 Msps) and K3's (24,002 at 24 Msps) blocks split
    over N CTAs per channel on a 132-SM card: at most 8 CTAs, never more
    CTAs than SMs while the channels fit, 16-sample slices whose N ranges
    are disjoint and cover every lane of the block."""
    n_sms = 132
    N, S = tk.cluster_split(C, blkp, n_sms)
    assert 1 <= N <= tk.MAX_CLUSTER
    if C <= n_sms:
        assert C * N <= n_sms
    assert S % 16 == 0 and N * S >= blkp
    owner = np.full(blkp, -1)
    for i in range(N):
        lanes = slice(i * S, min((i + 1) * S, blkp))
        assert (owner[lanes] == -1).all()
        owner[lanes] = i
    assert (owner >= 0).all()
    assert tk.plane_stride(blkp) % 128 == 0
    assert tk.plane_stride(blkp) >= blkp
    if (C, blkp) == (12, 24002):
        assert (N, S) == (8, 3008)
    if (C, blkp) == (12, 16802):
        assert (N, S) == (8, 2112)
    if (C, blkp) == (48, 24002):
        assert N == 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sig,trk", [
    (SIG, TRK), (BSIG, BTRK),
    (BSIG, TrackConfig(dll_bw=1.5, pll_bw=25.0, fll_bw=150.0,
                       fll_disc="atan", aid_div=1561.098e6 / 2.046e6))])
def test_cuda_kernel_matches_plain_twin(cuda_device, sig, trk):
    """K1 on the card against its twin at GPS (blkp 2,050) and BeiDou
    4.096 Msps (blkp 4,098, with each FLL), and two launches
    bit-identical."""
    C, n_blocks = 4, 12
    prns, chunk, tab, cb, ia, cp, dp = _setup(C, n_blocks, sig, trk)
    rows = tfused.fused_tap_rows(tab)
    port = tfused.make_fused_tracker(to_port(sig), to_port(trk),
                                     n_blocks=n_blocks)
    res = {}
    for dev in (CPU, cuda_device, cuda_device):
        before = tk.LAUNCHES["track_chunk_fused"]
        st, out = port(torch.tensor(chunk, device=dev),
                       torch.tensor(rows, device=dev),
                       (u32_tensor(cb, dev), torch.tensor(ia, device=dev)),
                       tscan.TrackState.init(cp, dp, device=dev))
        assert tk.LAUNCHES["track_chunk_fused"] == before + (
            dev.type == "cuda")
        got = jax.tree.map(lambda t: t.cpu(), (st, out))
        if dev.type in res:     # the second launch: bit-identical
            for a, b in zip(jax.tree.leaves(got),
                            jax.tree.leaves(res[dev.type])):
                assert torch.equal(a, b)
        res[dev.type] = got
    (gs, go), (rs, ro) = res["cuda"], res["cpu"]
    np.testing.assert_array_equal(go.blksize.numpy(), ro.blksize.numpy())
    np.testing.assert_array_equal(gs.corr.sample_pos.numpy(),
                                  rs.corr.sample_pos.numpy())
    for name in ACCS:
        np.testing.assert_allclose(getattr(go, name).numpy(),
                                   getattr(ro, name).numpy(),
                                   rtol=2e-3, atol=2.0)


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda_device):
    """A CUDA call the kernel cannot take raises; it never runs the twin."""
    C, blkp = 2, SIG.samples_per_code + 2
    d = cuda_device
    with pytest.raises(TypeError, match="pos0 dtype"):
        tk.track_chunk_fused(
            torch.zeros((8192, 2), device=d),
            torch.zeros((C, 128, tk.plane_stride(blkp)), dtype=torch.int8,
                        device=d),
            torch.zeros((C,), dtype=torch.int64, device=d),
            torch.zeros((C, tk.NF), device=d),
            torch.zeros((C,), dtype=torch.int64, device=d),
            torch.zeros((C,), dtype=torch.int64, device=d),
            n_blocks=1, blkp=blkp, code_length=1023, phases_per_chip=64,
            spacing=0.3, span_chips=1.0, base_code_step=0.5, fs=SIG.fs,
            coefs=(1.0,) * 5)
