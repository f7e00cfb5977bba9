"""The port's rational resampler (gnsstpu_torch/ops/resample.py) against
the reference's (gnsstpu/ops/resample.py, its apply jitted by JAX on the
CPU): the polyphase bank and window exactly, the apply at atol 1e-5 x the
input's peak (f32 sums over K taps in another order), the split apply
equal to the unsplit one, random access equal to one long read, the
nearest mode exactly, and the file producer's decimate-on-ingest feeding
the port's manager."""

import io

import numpy as np
import pytest
import torch

from gnsstpu import native as jnative
from gnsstpu.config import (AcqConfig, ReceiverConfig, SignalConfig,
                            TrackConfig)
from gnsstpu.ops import resample as jrs
from gnsstpu.runtime import sources as jsrc
from gnsstpu.sim import IFSimulator, SatParams
from gnsstpu_torch import native as tnative
from gnsstpu_torch.ops import resample as trs
from gnsstpu_torch.runtime import sources as tsrc
from gnsstpu_torch.runtime.manager import ChannelManager
from gnsstpu_torch.runtime.telemetry import Telemetry
from torch_port import one_torch_thread_per_worker, to_port  # noqa: F401

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
#: (fs_in, fs_out): the GN3S front end and the custom MAX2769 front end
#: to the receiver's 2.048 Msps, and the reference test's 2x decimator.
RATES = [(8.1838e6, 2.048e6), (16e6, 2.048e6), (4.096e6, 2.048e6)]
ATOL_PEAK = 1e-5


def _iq(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(n, 2)).astype(np.float32) * 20.0


@pytest.mark.parametrize("rates", RATES[:2])
def test_bank_and_window_exact(rates):
    p, q = trs.rational_ratio(*rates)
    assert (p, q) == jrs.rational_ratio(*rates)
    jb, tb = jrs.PolyphaseBank(p, q), trs.PolyphaseBank(p, q)
    assert tb.K == jb.K and tb.group_delay_up == jb.group_delay_up
    np.testing.assert_array_equal(tb.bank, jb.bank)
    for start, count in ((0, 257), (123_457, 1000)):
        jbase, jw = jb.window(start, count)
        tbase, tw = tb.window(start, count)
        np.testing.assert_array_equal(tbase, jbase)
        np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(trs.kaiser_lowpass(101, 0.3),
                                  jrs.kaiser_lowpass(101, 0.3))


@pytest.mark.parametrize("rates", RATES)
def test_polyphase_resample_matches_reference(rates):
    p, q = trs.rational_ratio(*rates)
    x = _iq(6000, 1)
    ref = jrs.polyphase_resample(x, p, q)
    got = trs.polyphase_resample(x, p, q, device="cpu")
    assert got.shape == ref.shape == (-(-6000 * p // q), 2)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=ATOL_PEAK * np.abs(x).max())


class _Inner:
    """A finite in-memory source (the reference's ArraySource protocol)."""

    def __init__(self, x):
        self.x = x

    def read(self, start, count):
        out = np.zeros((count, 2), np.float32)
        lo, hi = max(start, 0), min(start + count, len(self.x))
        if hi > lo:
            out[lo - start: hi - start] = self.x[lo:hi]
        return out

    def __len__(self):
        return len(self.x)


@pytest.mark.parametrize("rates", RATES[1:])
def test_resampled_source_matches_reference(rates):
    """ResampledSource.read at the start (negative input indices), in the
    middle and across the end, against the reference's."""
    x = _iq(40_000, 2)
    jr = jrs.ResampledSource(_Inner(x), *rates)
    tr = trs.ResampledSource(_Inner(x), *rates, device="cpu")
    assert len(tr) == len(jr)
    for start, count in ((0, 2048), (1000, 777), (len(jr) - 100, 300)):
        np.testing.assert_allclose(tr.read(start, count),
                                   jr.read(start, count), rtol=0,
                                   atol=ATOL_PEAK * np.abs(x).max())


def test_split_apply_equals_unsplit():
    """Outputs taken in pieces under a small window budget equal the
    apply in one piece, bit for bit."""
    bank = trs.PolyphaseBank(*trs.rational_ratio(16e6, 2.048e6))
    x = torch.as_tensor(_iq(60_000, 3))
    base, w = bank.window(0, 7000)
    rel = torch.as_tensor(base - base.min())
    w = torch.as_tensor(w)
    whole = trs.apply_window(x, rel, w, window_bytes=1 << 40)
    for budget in (1, 250 * 8 * 7, 250 * 8 * 1000 + 5):
        np.testing.assert_array_equal(
            trs.apply_window(x, rel, w, window_bytes=budget).numpy(),
            whole.numpy())


@pytest.mark.parametrize("mode", ["polyphase", "nearest"])
def test_random_access_equals_full_read(mode):
    x = _iq(30_000, 4)
    src = trs.ResampledSource(_Inner(x), 16e6, 2.048e6, mode=mode,
                              device="cpu")
    full = src.read(0, 3000)
    for start, count in ((0, 1), (17, 1024), (2047, 953)):
        np.testing.assert_array_equal(src.read(start, count),
                                      full[start: start + count])


def test_nearest_exact():
    x = _iq(20_000, 5)
    for rates in RATES:
        np.testing.assert_array_equal(
            trs.nearest_indices(*rates, 1234, 999),
            jrs.nearest_indices(*rates, 1234, 999))
        jr = jrs.ResampledSource(_Inner(x), *rates, mode="nearest")
        tr = trs.ResampledSource(_Inner(x), *rates, mode="nearest",
                                 device="cpu")
        np.testing.assert_array_equal(tr.read(5, 2000), jr.read(5, 2000))


@pytest.fixture(scope="module")
def hi_rate_file(tmp_path_factory):
    """1 s of a 2-SV sky at 4.096 Msps, 8-bit I/Q (tests/test_stream.py's
    resampling case)."""
    sig_in = SignalConfig(if_freq=0.0, fs=4.096e6, complex_iq=True)
    sats = [SatParams(prn=5, doppler_hz=900.0, code_phase_chips=200.5,
                      cn0_dbhz=47.0),
            SatParams(prn=12, doppler_hz=-1500.0,
                      code_phase_chips=700.25, cn0_dbhz=46.0)]
    raw = np.asarray(IFSimulator(sig_in, sats, noise_sigma=1.0,
                                 seed=3).generate(1000))
    path = tmp_path_factory.mktemp("if") / "hi_rate.bin"
    np.clip(np.round(raw * 18.0), -127, 127).astype(np.int8).tofile(path)
    return str(path)


def test_file_producer_blocks_match_reference(hi_rate_file):
    """Both packages' FileStreamProducer with fs_in resample the same
    file into the same 2.048 Msps blocks (atol 1e-5 x the peak)."""
    blk = SIG.samples_per_code
    got = {}
    for name, mod, smod, kw in (("ref", jnative, jsrc, {}),
                                ("port", tnative, tsrc, {"device": "cpu"})):
        fifo = mod.RingFifo(depth=8, block_bytes=blk * 8)
        prod = smod.FileStreamProducer(hi_rate_file, fifo, blk,
                                       fmt="i8_iq", fs_in=4.096e6,
                                       fs_out=SIG.fs, **kw).start()
        blocks = []
        try:
            for _ in range(20):
                r, b = fifo.pop(timeout_ms=10_000)
                assert r == 1
                blocks.append(b.view(np.float32).reshape(blk, 2))
        finally:
            prod.stop()
            fifo.close()
            prod.thread.join(timeout=10.0)
        assert not prod.thread.is_alive()
        got[name] = np.concatenate(blocks)
    np.testing.assert_allclose(got["port"], got["ref"], rtol=0,
                               atol=ATOL_PEAK * 127)
    # The port reads FileStreamProducer.READ_BLOCKS blocks per resampler
    # call: the blocks are the per-block reads' bit for bit.
    src = trs.ResampledSource(tsrc.FileSource(hi_rate_file), 4.096e6,
                              SIG.fs, device="cpu")
    np.testing.assert_array_equal(
        got["port"], np.concatenate([src.read(i * blk, blk)
                                     for i in range(20)]))


def test_live_resampling_producer_tracks(hi_rate_file):
    """Decimate-on-ingest (tests/test_stream.py:300-341 on the port): the
    4.096 Msps file streams through the producer's polyphase resampler to
    2.048 Msps, and the port's manager (CPU) acquires and tracks both
    SVs at the right Doppler."""
    blk = SIG.samples_per_code
    fifo = tnative.RingFifo(depth=256, block_bytes=blk * 8)
    prod = tsrc.FileStreamProducer(hi_rate_file, fifo, blk, fmt="i8_iq",
                                   fs_in=4.096e6, fs_out=SIG.fs,
                                   device="cpu").start()
    try:
        src = tsrc.StreamSource(fifo, blk, timeout_s=20.0)
        cfg = ReceiverConfig(
            signal=SIG,
            acq=AcqConfig(doppler_band=6e3, coherent_ms=2, threshold=2.4,
                          prn_list=(5, 12), fine_doppler_ms=10),
            track=TrackConfig(dll_bw=1.0), n_channels=3)
        mgr = ChannelManager(
            src, to_port(cfg), device="cpu",
            telemetry=Telemetry(sink=io.StringIO()), epoch_ms=100,
            reacq_period_ms=400, cn0_drop_dbhz=35.0, prn_pool=[5, 12],
            sync_every=2)
        recs = mgr.run(900)
    finally:
        prod.stop()
        fifo.close()
        prod.thread.join(timeout=10.0)
    assert not prod.thread.is_alive()
    last = recs[-1]
    assert {int(p) for p in last.prn if p} == {5, 12}
    i5, i12 = list(last.prn).index(5), list(last.prn).index(12)
    assert abs(last.doppler_hz[i5] - 900.0) < 5.0
    assert abs(last.doppler_hz[i12] + 1500.0) < 5.0
    assert last.cn0_dbhz[i5] > 38.0
