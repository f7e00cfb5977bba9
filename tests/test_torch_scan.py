"""Port scan tracker (gather + table modes) vs gnsstpu.tracking.scan.

Same inputs (JAX IFSimulator on the CPU, numpy tables and state), same
algorithm: block geometry and sample cursors must be exact, and the
floating-point outputs agree to rtol 1e-5 / atol 1e-3 — the two differ
only in f32 summation order (XLA dot vs torch.bmm) and last-ulp
cos/sin/atan differences between the two CPU math libraries. The six
accumulators are 2050-term f32 sums whose terms total ~1.6e3 in
magnitude; a different summation order moves them by up to ~1e-6 of that
(~2e-3) whatever the size of the result, so they get atol 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnsstpu.config import SignalConfig, TrackConfig
from gnsstpu.ops import code_tables
from gnsstpu.sim import IFSimulator, SatParams
from gnsstpu.tracking import scan as jscan
from gnsstpu_torch.device import u32_numpy, u32_tensor
from gnsstpu_torch.tracking import scan as tscan
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import to_port

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
TRK = TrackConfig(dll_bw=1.0, el_spacing=0.3)
TSIG, TTRK = to_port(SIG), to_port(TRK)
CPU = torch.device("cpu")
ACCS = ("ie", "qe", "ip", "qp", "il", "ql")
FIELDS = ("carr_doppler", "code_freq_delta", "rem_code_phase", "dll_disc",
          "dll_disc_filt", "pll_disc", "pll_disc_filt")


def setup(C, n_blocks, mode):
    prns = [3, 9, 17, 25, 5, 12, 22, 28, 31, 7][:C]
    sats = [SatParams(prn=p, doppler_hz=400.0 * i - 600.0,
                      code_phase_chips=50.0 * i + 11.0, cn0_dbhz=49.0)
            for i, p in enumerate(prns)]
    chunk = np.asarray(IFSimulator(SIG, sats, noise_sigma=1.0,
                                   seed=4).generate(n_blocks + 3))
    spc = SIG.samples_per_code
    if mode == "table":
        tab = code_tables.phase_row_table(
            SIG.signal, SIG.fs, SIG.code_freq, SIG.code_length, spc + 2)
    else:
        tab = code_tables.padded_code_table(SIG.signal)
    codes = np.stack([tab[p - 1] for p in prns]).astype(np.float32)
    cb, ia = jscan.channel_consts(SIG, TRK, prns)
    spchip = SIG.fs / SIG.code_freq
    cp = np.array([int(round(s.code_phase_chips * spchip)) for s in sats])
    dp = np.array([s.doppler_hz + 37.0 for s in sats], np.float32)
    return chunk, codes, cb, ia, cp, dp


def run_jax(mode, n_blocks, chunk, codes, cb, ia, cp, dp):
    st0 = jax.tree.map(jnp.asarray, jscan.TrackState.init(cp, dp))
    tr = jscan.make_tracker(SIG, TRK, n_blocks=n_blocks, code_mode=mode)
    return tr(jnp.asarray(chunk), jnp.asarray(codes),
              (jnp.asarray(cb), jnp.asarray(ia)), st0)


def run_torch(mode, n_blocks, chunk, codes, cb, ia, cp, dp):
    st0 = tscan.TrackState.init(cp, dp, device=CPU)
    tr = tscan.make_tracker(TSIG, TTRK, n_blocks=n_blocks, code_mode=mode)
    return tr(torch.tensor(chunk), torch.tensor(codes),
              (u32_tensor(cb, CPU), torch.from_numpy(ia)), st0)


def test_channel_consts_match():
    for offs in (None, [0.0, 562.5e3, -1125e3]):
        a = jscan.channel_consts(SIG, TRK, [1, 2, 3], if_offsets_hz=offs)
        b = tscan.channel_consts(TSIG, TTRK, [1, 2, 3], if_offsets_hz=offs)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("mode", ["gather", "table"])
def test_scan_matches_reference(mode):
    C, n_blocks = 4, 12
    args = setup(C, n_blocks, mode)
    js, jo = run_jax(mode, n_blocks, *args)
    ts, to = run_torch(mode, n_blocks, *args)

    np.testing.assert_array_equal(to.blksize.numpy(), np.asarray(jo.blksize))
    np.testing.assert_array_equal(ts.corr.sample_pos.numpy(),
                                  np.asarray(js.corr.sample_pos))
    for name in ACCS + FIELDS:
        np.testing.assert_allclose(getattr(to, name).numpy(),
                                   np.asarray(getattr(jo, name)),
                                   rtol=1e-5,
                                   atol=2e-3 if name in ACCS else 1e-3,
                                   err_msg=name)
    # Carrier NCO phase: exact unless f32 noise tips an NCO step rounding
    # by one LSB on some block (each flip moves the phase by <= blkmax).
    d = (u32_numpy(ts.corr.carr_phase_u32).astype(np.int64)
         - np.asarray(js.corr.carr_phase_u32).astype(np.int64))
    d = (d + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert np.max(np.abs(d)) <= n_blocks * (SIG.samples_per_code + 2)
