"""The port's offline tracking driver (tracking/driver.py::track) vs
gnsstpu's, on the CPU.

Same numpy-made samples (gnsstpu's IFSimulator) through both drivers,
~600 ms at chunk_ms 128 so that the chunk rebase at the slowest channel
runs five times:
  * 'gather' against 'gather' (the exact scan engines): blksize and the
    f64 abs_sample bookkeeping exact, loop outputs at test_torch_scan.py's
    rtol 1e-5 / atol 1e-3; accumulators at rtol 1e-5 / atol 3e-3: the
    f32 summation order of a 2,048-term block moves them by ~1e-3 on
    every block (it does not grow over the run), and by up to 2.5e-3 on
    one block of the 1,200 here, where test_torch_scan.py's 2e-3 holds
    for its 48 channel-blocks;
  * the port's 'fused' (kernel K1's plain twin, the CPU path of the
    wrapper) against the reference's scan in 'table' mode, the engine
    whose 1/64-chip phase rows K1 shares (as
    test_torch_track_kernel.py::test_k1_atan_fll_matches_reference_scan
    holds it): tests/test_track_kernel.py's tolerances, blksize exact,
    accumulators rtol 2e-3 / atol 2, carrier Doppler 0.05 Hz;
  * GPS L1 C/A at 2.048 Msps (3 channels) and GLONASS L1OF at 2.048 Msps
    on two FDMA channels with nonzero if_offset_hz;
  * the end of a chunk: channels spread over one code period with code
    Dopplers of both signs, every block of every chunk inside the samples
    read for it (the kernels read zeros past a chunk, the scan engines
    clamp their window, so the engines agree only there).
"""

import numpy as np
import pytest

from gnsstpu.config import SignalConfig, TrackConfig
from gnsstpu.runtime.sources import ArraySource as JArraySource
from gnsstpu.sim import IFSimulator, SatParams
from gnsstpu.tracking import driver as jdriver
from gnsstpu_torch.ops import track_kernel as tk
from gnsstpu_torch.runtime.sources import ArraySource
from gnsstpu_torch.tracking import driver as tdriver
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import to_port

GPS = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
GTRK = TrackConfig(dll_bw=1.0, pll_bw=25.0, fll_bw=250.0)
GLO = SignalConfig(signal="glonass_l1of", if_freq=0.0, fs=2.048e6,
                   code_freq=0.511e6, code_length=511, fdma_step=562.5e3,
                   complex_iq=True)
OTRK = TrackConfig(dll_bw=1.0, pll_bw=25.0, fll_bw=250.0,
                   aid_div=1602e6 / 0.511e6)
N_MS, CHUNK_MS = 600, 128
ACCS = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l")
LOOP = ("carr_freq", "code_freq", "dll_disc", "dll_disc_filt", "pll_disc",
        "pll_disc_filt")


def _case(name):
    """(sig, trk, samples, [jdriver.ChannelInit]) of one test signal; the
    handoff is the truth's code phase and a Doppler 20 Hz off."""
    if name == "gps":
        sig, trk = GPS, GTRK
        sats = [SatParams(prn=p, doppler_hz=d, code_phase_chips=c,
                          cn0_dbhz=47.0)
                for p, d, c in ((3, -2400.0, 50.25), (17, 300.0, 511.5),
                                (25, 3100.0, 1001.75))]
    else:
        sig, trk = GLO, OTRK
        # Frequency channels k = -1 and +2 (registry prn = k + 8).
        sats = [SatParams(prn=p, doppler_hz=d, code_phase_chips=c,
                          cn0_dbhz=48.0, if_offset_hz=k * 562.5e3)
                for p, k, d, c in ((7, -1, -1500.0, 100.5),
                                   (10, 2, 2200.0, 400.25))]
    x = np.asarray(IFSimulator(sig, sats, noise_sigma=1.0,
                               seed=11).generate(N_MS + 40))
    spchip = sig.fs / sig.code_freq
    chans = [jdriver.ChannelInit(
        prn=s.prn, code_phase=int(round(s.code_phase_chips * spchip)),
        doppler_hz=s.doppler_hz + 20.0, if_offset_hz=s.if_offset_hz)
        for s in sats]
    return sig, trk, x, chans


@pytest.fixture(scope="module", params=["gps", "glonass_l1of"])
def case(request):
    return _case(request.param)


def _run(sig, trk, x, chans, ref_mode, port_mode):
    ref = jdriver.track(JArraySource(x), chans, sig, trk, N_MS,
                        chunk_ms=CHUNK_MS, code_mode=ref_mode)
    before = tk.LAUNCHES["track_chunk_fused"]
    got = tdriver.track(ArraySource(x), [to_port(c) for c in chans],
                        to_port(sig), to_port(trk), N_MS, chunk_ms=CHUNK_MS,
                        code_mode=port_mode, device="cpu")
    # On the CPU the wrapper runs K1's plain twin: no launch is counted.
    assert tk.LAUNCHES["track_chunk_fused"] == before
    return ref, got


def test_gather_matches_reference_gather(case):
    sig, trk, x, chans = case
    ref, got = _run(sig, trk, x, chans, "gather", "gather")
    np.testing.assert_array_equal(got.prn, ref.prn)
    np.testing.assert_array_equal(got.status, ref.status)
    assert got.i_p.shape == (len(chans), N_MS)
    np.testing.assert_array_equal(got.abs_sample, ref.abs_sample)
    for name in ACCS:
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-5, atol=3e-3, err_msg=name)
    for name in LOOP:
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-5, atol=1e-3, err_msg=name)
    # The loops held lock: the last 100 ms of Doppler near the truth.
    truth = np.array([c.doppler_hz - 20.0 for c in chans])
    dopp = got.carr_freq - sig.if_freq - np.array(
        [c.if_offset_hz for c in chans])[:, None]
    assert np.all(np.abs(dopp[:, -100:].mean(1) - truth) < 5.0)


def _slip(tr, sig):
    """tdriver.replica_slip_samples of a record, at the nominal block
    length (the blocks' own lengths move it by under 1e-5 sample)."""
    return tdriver.replica_slip_samples(
        tr.code_freq - sig.code_freq,
        np.full(tr.code_freq.shape, sig.samples_per_code), sig.code_freq)


def test_fused_matches_reference_table(case):
    sig, trk, x, chans = case
    ref, got = _run(sig, trk, x, chans, "table", "fused")
    spchip = sig.fs / sig.code_freq
    # The same blocks: the f64 abs_sample bookkeeping differs by the f32
    # remainder (5e-4 chip) it subtracts, after the port's half-slip term
    # (which the reference's drivers lack).
    np.testing.assert_allclose(got.abs_sample,
                               ref.abs_sample + _slip(ref, sig), rtol=0,
                               atol=5e-4 * spchip)
    for name in ACCS:
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=2e-3, atol=2.0, err_msg=name)
    np.testing.assert_allclose(got.carr_freq, ref.carr_freq, rtol=0,
                               atol=0.05)


def test_fused_abs_sample_follows_the_exact_engine():
    """K1's twin against the exact 'gather' engine over 3 s at 50 dB-Hz,
    six GPS channels from -4 to +4 kHz: the fused engine's code phase
    runs ahead of the exact engine's by the replica's half slip over a
    block (code Doppler x (blksize - 1) / 2 code_freq samples), which the
    driver takes off. Left in, that term spreads the channels' mean
    fused - exact abs_sample over 5.7e-3 sample (0.8 m: the pseudorange
    bias of a fix); taken off, the spread left is under 1.5e-3."""
    sig, trk = GPS, GTRK
    n = 3000
    sats = [SatParams(prn=p, doppler_hz=d, code_phase_chips=50.0 + 150.3 * i,
                      cn0_dbhz=50.0)
            for i, (p, d) in enumerate(zip(
                [3, 9, 17, 25, 5, 12],
                [-4000.0, -2500.0, -1000.0, 1000.0, 2500.0, 4000.0]))]
    x = np.asarray(IFSimulator(sig, sats, noise_sigma=1.0,
                               seed=5).generate(n + 30))
    spchip = sig.fs / sig.code_freq
    chans = [tdriver.ChannelInit(
        prn=s.prn, code_phase=int(round(s.code_phase_chips * spchip)),
        doppler_hz=s.doppler_hz) for s in sats]
    fused, exact = (tdriver.track(ArraySource(x), chans, to_port(sig),
                                  to_port(trk), n, code_mode=m,
                                  device="cpu")
                    for m in ("fused", "gather"))
    settled = slice(n // 3, n)
    slip = _slip(fused, sig)[:, settled].mean(1)
    diff = (fused.abs_sample - exact.abs_sample)[:, settled].mean(1)
    assert np.ptp(slip) > 5.0e-3
    assert np.ptp(diff - slip) > 4.0e-3          # the term, left in
    assert np.ptp(diff) < 1.5e-3                 # taken off


class _Recorder:
    """A source that records each read (start, count)."""

    def __init__(self, src):
        self.src, self.reads = src, []

    def read(self, start, count):
        self.reads.append((start, count))
        return self.src.read(start, count)


@pytest.mark.parametrize("mode", ["fused", "gather"])
def test_every_block_stays_inside_its_chunk(mode):
    """Channels one code period apart, the later one with negative and
    the earlier with positive code Doppler (blocks longer and shorter than
    a code period), so after each rebase the later one sits near
    rel = spc + drift: every block's window [start, start + blkp) of every
    chunk lies inside the samples read for that chunk."""
    sig, trk = GPS, GTRK
    spc = sig.samples_per_code
    sats = [SatParams(prn=3, doppler_hz=4500.0, code_phase_chips=0.5,
                      cn0_dbhz=49.0),
            SatParams(prn=17, doppler_hz=-4500.0, code_phase_chips=1022.0,
                      cn0_dbhz=49.0)]
    x = np.asarray(IFSimulator(sig, sats, noise_sigma=1.0,
                               seed=2).generate(N_MS + 40))
    chans = [tdriver.ChannelInit(prn=s.prn, code_phase=int(round(
        s.code_phase_chips * sig.fs / sig.code_freq)) % spc,
        doppler_hz=s.doppler_hz) for s in sats]
    src = _Recorder(ArraySource(x))
    tr = tdriver.track(src, chans, to_port(sig), to_port(trk), N_MS,
                       chunk_ms=CHUNK_MS, code_mode=mode, device="cpu")
    assert len(src.reads) == int(np.ceil(N_MS / CHUNK_MS))
    assert {n for _, n in src.reads} == {
        tdriver.chunk_samples(to_port(sig), N_MS, CHUNK_MS)}
    # Block boundaries are whole samples: abs_sample is one less the
    # remainder in samples (under one), so a block ends at its ceiling.
    ends = np.concatenate([np.array([[c.code_phase] for c in chans],
                                    np.float64),
                           np.ceil(tr.abs_sample - 1e-6)], axis=1)
    for k, (s0, count) in enumerate(src.reads):
        blocks = slice(k * CHUNK_MS, min((k + 1) * CHUNK_MS, N_MS))
        starts = ends[:, blocks]            # each block's first sample
        assert starts.min() >= s0
        assert starts.max() + spc + 2 <= s0 + count, (k, s0, count)
    # The later channel ran ahead of the earlier by about a code period.
    rel = ends[1] - ends[0]
    assert rel.min() > 0.9 * spc
