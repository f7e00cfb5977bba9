"""The port's joint GPS + GLONASS fix against gnsstpu's, on the CPU.

tests/test_joint_pvt.py's path after the tracker: 3 GPS L1 C/A SVs
(visible_ephs(6)[:3]) and 3 GLONASS L1OF SVs (make_glonass_constellation
(n=3)) against one receiver, both at 4.096 Msps over 24 s. Each system's
record is built without a tracker (torch_port.nav_record: each channel's
prompts are its nav symbols with seeded noise, abs_sample the sample
where each code period ends under the simulator's code-phase model, the
GLONASS channels on their own FDMA carriers). Both packages run
decode_nav on the same records; for the joint fix each builds one
SystemObs per system (the reference with its test's _system_obs, the port
with chip_smoke.system_obs, which phase 38 runs on the card) and solves
navigate_joint over 10 epochs. All of it is numpy code on each package's
copy of gnsstpu.nav, so every port output must equal the reference's.

The reference test's GLONASS message holds 8 strings, which end 18 s into
its 24 s signal; past them the simulator holds the last symbol, so the
decoder's later string slots read noise, and a noise string that passes
the KX check overwrites ephemeris fields (both packages alike). The decode
case runs that message; the joint fix runs a message of 11 strings, which
covers the record, and is held to tests/test_joint_pvt.py:108-124's limits
besides. Each system alone decodes its 3 ephemerides (the GLONASS ones as
the scenario's quantized truth) and gives no fix.
"""

import types

import numpy as np
import pytest

from chip_smoke import joint_fix_checks, system_obs
from gnsstpu.config import NavConfig, SignalConfig
from gnsstpu.nav import pvt as jpvt
from gnsstpu.runtime import receiver as jrec
from gnsstpu.sim.scenario import build_scenario, build_scenario_glonass
from gnsstpu.tracking import driver as jdriver
from gnsstpu_torch.nav import pvt as tpvt
from gnsstpu_torch.runtime import receiver as trec
from gnsstpu_torch.tracking import driver as tdriver
from test_full_chain import TOW0_6S, visible_ephs
from test_glonass import GFIX_T0, make_glonass_constellation
from test_joint_pvt import FS, N_MS, RECV, _system_obs
from torch_port import one_torch_thread_per_worker  # noqa: F401
from torch_port import nav_record, to_port

SIG_G = SignalConfig(if_freq=0.0, fs=FS, complex_iq=True)
SIG_R = SignalConfig(signal="glonass_l1of", if_freq=0.0, fs=FS,
                     code_freq=0.511e6, code_length=511, fdma_step=562.5e3,
                     complex_iq=True)
NAV = NavConfig(sol_period_ms=500, elevation_mask_deg=10.0, use_tropo=False)
N_EPOCHS = 10


#: GLONASS strings: the reference test's message, and one that covers the
#: 24 s record (a 2 s lead string, then 11 strings of 2 s).
REF_STRINGS, RECORD_STRINGS = 8, 11


def _records(n_strings: int) -> dict:
    """{system: (sig, TrackResults fields, channels, truth ephemerides)} on
    the reference test's skies, the GLONASS message n_strings long."""
    ephs_g = dict(list(visible_ephs(6).items())[:3])
    sats_g = build_scenario(SIG_G, ephs_g, RECV, TOW0_6S,
                            duration_s=N_MS / 1000.0, cn0_dbhz=47.0)
    sats_r, qephs = build_scenario_glonass(
        SIG_R, make_glonass_constellation(RECV, n=3), RECV, GFIX_T0,
        duration_s=N_MS / 1000.0, cn0_dbhz=48.0, n_strings=n_strings)
    out = {}
    for name, sig, sats, truth, seed in (("gps", SIG_G, sats_g, ephs_g, 3),
                                         ("glonass", SIG_R, sats_r, qephs,
                                          5)):
        i_p, abs_s, carr = nav_record(sig, sats, N_MS, seed)
        z = np.zeros_like(i_p)
        fields = dict(prn=np.array([s.prn for s in sats]),
                      status=np.ones(len(sats), bool), i_e=z, q_e=z,
                      i_p=i_p, q_p=z, i_l=z, q_l=z, carr_freq=carr,
                      code_freq=np.full(i_p.shape, sig.code_freq),
                      abs_sample=abs_s, dll_disc=z, dll_disc_filt=z,
                      pll_disc=z, pll_disc_filt=z)
        chans = [dict(prn=s.prn, code_phase=0, doppler_hz=s.doppler_hz)
                 for s in sats]
        out[name] = (sig, fields, chans, truth)
    return out


def _outputs(rec, drv, records, port: bool) -> dict:
    """{system: (ReceiverOutput-like namespace, fix alone, satpos_fn)} of
    one package's decode_nav and navigate_from_anchors on the records."""
    res = {}
    for name, (sig, fields, chans, _) in records.items():
        s, nav = (to_port(sig), to_port(NAV)) if port else (sig, NAV)
        tr = drv.TrackResults(**{k: v.copy() for k, v in fields.items()})
        ch = [drv.ChannelInit(**c) for c in chans]
        _, anchors, ephs, _, fns = rec.decode_nav(tr, ch, s)
        alone = rec.navigate_from_anchors(tr, ch, anchors, ephs, s, nav,
                                          N_MS, fns)
        out = types.SimpleNamespace(channels=ch, ephs=ephs,
                                    anchors=anchors, track=tr)
        res[name] = (out, alone, fns[0])
    return res


@pytest.mark.parametrize("n_strings", [REF_STRINGS, RECORD_STRINGS])
def test_decode_matches_reference(n_strings):
    """decode_nav of both packages: the same ephemerides, anchors and
    times; each system alone decodes 3 ephemerides and gives no fix."""
    records = _records(n_strings)
    ref = _outputs(jrec, jdriver, records, port=False)
    got = _outputs(trec, tdriver, records, port=True)
    for name, (_, _, _, truth) in records.items():
        (jo, jalone, _), (to, talone, _) = ref[name], got[name]
        assert sorted(jo.ephs) == sorted(to.ephs) == sorted(truth), name
        for prn in truth:
            assert vars(to.ephs[prn]) == vars(jo.ephs[prn]), (name, prn)
        assert ([vars(a) for a in to.anchors]
                == [vars(a) for a in jo.anchors]), name
        assert jalone is None and talone is None, name
        if name == "glonass" and n_strings == RECORD_STRINGS:
            for prn, eph in truth.items():
                assert vars(to.ephs[prn]) == vars(to_port(eph)), prn


def test_joint_fix_matches_reference():
    records = _records(RECORD_STRINGS)
    ref = _outputs(jrec, jdriver, records, port=False)
    got = _outputs(trec, tdriver, records, port=True)
    jsol = jpvt.navigate_joint(
        [_system_obs(ref[n][0], records[n][0], ref[n][2])
         for n in ("gps", "glonass")], NAV, N_EPOCHS)
    tsol = tpvt.navigate_joint(
        [system_obs(got[n][0], to_port(records[n][0]), got[n][2])
         for n in ("gps", "glonass")], to_port(NAV), N_EPOCHS)
    # The port's solution: the reference's exactly.
    for name, want in vars(jsol).items():
        have = getattr(tsol, name)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(have, want, err_msg=name)
        else:
            assert have == want, name
    # tests/test_joint_pvt.py:108-124's limits, and phase 38's checks.
    v = tsol.valid
    assert v.sum() >= 8
    err = np.linalg.norm(np.stack([tsol.x[v], tsol.y[v], tsol.z[v]], 1)
                         - RECV, axis=1)
    assert err.mean() < 30.0 and err.max() < 100.0
    assert np.std(tsol.inter_sys[v, 0]) < 15.0
    assert np.all(tsol.n_sats[v] == 6)
    assert all(joint_fix_checks(tsol, RECV)["checks"].values())
