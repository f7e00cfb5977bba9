"""The port's GLONASS P-code tracker (tracking/pcode.py) vs gnsstpu's, on
the CPU.

tests/test_glonass.py::test_l2_pcode_closed_loop's input (the aperiodic
5.11 Mcps P code at 12 Msps, 870 Hz Doppler on frequency channel -1,
handed over 15 Hz off at a mid-second chip offset), made with numpy from
its seed, through both trackers for 40 blocks: chip_off and sample_pos
exact, the per-block blksize exact, the accumulators at the scan
tolerances scaled to the 12,000-sample block (rtol 1e-5, atol 8e-3, as
tests/test_torch_dual.py's scan bound for 12,000 samples), the loop
outputs at atol 1e-3. The port's loop is also held to converge as the
reference test's is, over its full 150 blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnsstpu.config import TrackConfig
from gnsstpu.signals.glonass import generate_p_code
from gnsstpu.tracking import pcode as jpcode
from gnsstpu_torch.tracking import pcode as tpcode
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import to_port

FS, IF = 12.0e6, 0.0
DOPP = 870.0
F_CARR = 1.246e9 - 437.5e3              # frequency channel -1
AID = F_CARR / jpcode.P_CODE_FREQ
CHIP0 = 3 * jpcode.BLOCK_CHIPS + 1234
AMP = 1.2
TRK = TrackConfig(dll_bw=5.0, el_spacing=0.3)


def signal(n_ms):
    """(chunk [N, 2] f32, code f32, first sample) as the reference test
    makes them."""
    n_chips = (n_ms + 6) * jpcode.BLOCK_CHIPS + CHIP0
    code = generate_p_code(n_chips).astype(np.float64)
    n = int(FS * (n_ms + 4) * 1e-3)
    t = np.arange(n) / FS
    f_code = jpcode.P_CODE_FREQ * (1.0 + DOPP / F_CARR)
    idx = np.floor(CHIP0 + 0.08 + f_code * t).astype(np.int64)
    rng = np.random.default_rng(9)
    phase = 2 * np.pi * (IF + DOPP) * t + 0.6
    sig_i = AMP * code[idx] * np.cos(phase) + rng.normal(0, 1.0, n)
    sig_q = AMP * code[idx] * np.sin(phase) + rng.normal(0, 1.0, n)
    chunk = np.stack([sig_i, sig_q], 1).astype(np.float32)
    return chunk, code.astype(np.float32), int(np.searchsorted(idx, CHIP0))


def _port(chunk, code, start, n_ms):
    tr = tpcode.make_pcode_tracker(FS, IF, to_port(TRK), n_blocks=n_ms,
                                   aid_div=AID)
    st = tpcode.PState.init(sample_pos=start, chip_off=CHIP0,
                            doppler_hz=DOPP - 15.0, aid_div=AID,
                            device="cpu")
    return tr(torch.tensor(chunk), torch.tensor(code), st)


def test_constants_match():
    assert tpcode.P_CODE_FREQ == jpcode.P_CODE_FREQ
    assert tpcode.BLOCK_CHIPS == jpcode.BLOCK_CHIPS
    assert list(tpcode.PState._fields) == list(jpcode.PState._fields)


def test_pcode_tracker_matches_reference():
    n_ms = 40
    chunk, code, start = signal(n_ms)
    ref = jpcode.make_pcode_tracker(FS, IF, TRK, n_blocks=n_ms, aid_div=AID)
    st = jpcode.PState.init(sample_pos=0, chip_off=CHIP0,
                            doppler_hz=DOPP - 15.0, aid_div=AID)
    st = st._replace(sample_pos=jnp.int32(start))
    rs, ro = ref(jnp.asarray(chunk), jnp.asarray(code), st)
    gs, go = _port(chunk, code, start, n_ms)

    assert int(gs.chip_off) == int(rs.chip_off)
    assert int(gs.sample_pos) == int(rs.sample_pos)
    np.testing.assert_array_equal(go["blksize"].numpy(),
                                  np.asarray(ro["blksize"]))
    for name in ("ip", "qp", "ie", "il"):
        np.testing.assert_allclose(go[name].numpy(), np.asarray(ro[name]),
                                   rtol=1e-5, atol=8e-3, err_msg=name)
    for name in ("carr_doppler", "code_err", "rem"):
        np.testing.assert_allclose(go[name].numpy(), np.asarray(ro[name]),
                                   rtol=1e-5, atol=1e-3, err_msg=name)
    np.testing.assert_allclose(gs.carr_delta.numpy(),
                               np.asarray(rs.carr_delta), rtol=0, atol=1e-3)
    d = (int(gs.carr_phase_u32) - int(rs.carr_phase_u32) + 2 ** 31) \
        % 2 ** 32 - 2 ** 31
    assert abs(d) <= n_ms * (int(np.ceil(FS * 1e-3)) + 2)


def test_pcode_closed_loop_converges():
    """The reference test's limits on the port's loop (150 blocks)."""
    n_ms = 150
    chunk, code, start = signal(n_ms)
    _, outs = _port(chunk, code, start, n_ms)
    ip = outs["ip"].numpy()
    dopp = outs["carr_doppler"].numpy()
    assert np.abs(ip[-40:]).mean() > 0.5 * AMP * (FS / 1000)
    assert abs(np.mean(dopp[-40:]) - DOPP) < 2.0
    assert np.abs(outs["code_err"].numpy()[-40:]).mean() < 0.04


def test_pstate_defaults_to_the_card():
    """Without `device` the state asks for the card: on a host without
    one it raises, never quietly running on the CPU."""
    def init():
        return tpcode.PState.init(sample_pos=0, chip_off=0, doppler_hz=0.0,
                                  aid_div=AID)

    if torch.cuda.is_available():
        assert init().rem.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="is_available"):
        init()

