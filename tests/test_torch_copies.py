"""The port's copies of the reference's host modules.

gnsstpu_torch carries its own copy of every gnsstpu module that it or
chip_smoke.py reaches (config, signal definitions, code tables, nav
decode and PVT, the online navigator, telemetry, the command console, the
checkpoint file format, the remote station, the diagnostic plots) and of
the native library's C++ sources (the ring FIFO, the sample codecs and
packer, the GP2021 golden model).
Each copy is the origin verbatim except for the import prefix
(`gnsstpu.` -> `gnsstpu_torch.` on import lines) and one docstring line
naming the origin. The port extends two of them, the online navigator
and telemetry, with its tracing spans, and the navigator with fixes in
the manager's clock: every line of their origin stays, in order (the port
adds lines and may indent the origin's into blocks it adds).
test_copies_match_their_origin is the drift guard: a later fix in gnsstpu
that is not carried over fails it. The other tests run both copies on the
same inputs.

Neither package's copies import JAX, so this file runs both side by side
without it.
"""

import importlib
import re
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

#: Modules copied verbatim, as paths relative to the package root.
COPIES = (
    "config.py",
    "signals/__init__.py", "signals/registry.py", "signals/gps_l1ca.py",
    "signals/glonass.py", "signals/beidou_b1.py", "signals/galileo_e1.py",
    "signals/glonass_l3.py",
    "ops/code_tables.py", "ops/iq.py",
    "nav/__init__.py", "nav/types.py", "nav/geodesy.py", "nav/orbits.py",
    "nav/lnav.py", "nav/frame.py", "nav/pvt.py", "nav/iono.py",
    "nav/ekf.py", "nav/almanac.py", "nav/visibility.py", "nav/glonass.py",
    "nav/beidou.py", "nav/galileo.py", "nav/viterbi.py", "nav/glonass_l3.py",
    "runtime/navigator.py", "runtime/telemetry.py", "runtime/console.py",
    "runtime/checkpoint.py", "runtime/remote.py", "runtime/station.py",
    "viz.py",
)
#: Binary data copied byte for byte.
DATA = ("signals/data/galileo_e1_codes.npz",)
#: Native sources copied byte for byte, as (path in the port, path in the
#: repo): their origin is the reference's native/, not gnsstpu/.
NATIVE = (("csrc/host/ring_fifo.cpp", "native/src/ring_fifo.cpp"),
          ("csrc/host/sample_codec.cpp", "native/src/sample_codec.cpp"),
          ("csrc/host/gp2021_model.cpp", "native/src/gp2021_model.cpp"))

#: Copies the port extends with its spans (the rest are verbatim).
EXTENDED = ("runtime/navigator.py", "runtime/telemetry.py")
NOTE = "Copied from gnsstpu/{rel}; only the import prefix differs."
EXTENDED_NOTE = "Copied from gnsstpu/{rel}, with the port's spans added."
_IMPORT = re.compile(r"^(\s*)(from|import)(\s+)gnsstpu\.", re.M)


def port_copy(src: str, rel: str, note: str = NOTE) -> str:
    """The port's copy of gnsstpu/<rel> given its source: import lines
    rewritten to gnsstpu_torch, and a note naming the origin as the last
    line of the module docstring (a new docstring where there is none)."""
    out = _IMPORT.sub(r"\1\2\3gnsstpu_torch.", src)
    note = note.format(rel=rel)
    m = re.match(r'"""', out)
    if m is None:
        return f'"""{note}"""\n' + out
    end = out.index('"""', 3)
    sep = "\n" if out[end - 1] == "\n" else "\n\n"
    return out[:end] + sep + note + "\n" + out[end:]


@pytest.mark.parametrize("rel", COPIES)
def test_copies_match_their_origin(rel):
    origin = (REPO / "gnsstpu" / rel).read_text()
    copy = (REPO / "gnsstpu_torch" / rel).read_text()
    if rel in EXTENDED:
        have = iter(line.strip() for line in copy.splitlines())
        lost = [line for line in port_copy(origin, rel, EXTENDED_NOTE)
                .splitlines() if line.strip() not in have]
        assert not lost, (
            f"gnsstpu_torch/{rel} lost lines of gnsstpu/{rel} (first: "
            f"{lost[0]!r}): carry the change over")
        return
    assert copy == port_copy(origin, rel), (
        f"gnsstpu_torch/{rel} drifted from gnsstpu/{rel}: carry the change "
        "over (only the import prefix may differ)")


@pytest.mark.parametrize("rel", DATA)
def test_data_files_match_their_origin(rel):
    assert ((REPO / "gnsstpu_torch" / rel).read_bytes()
            == (REPO / "gnsstpu" / rel).read_bytes())


@pytest.mark.parametrize("rel,origin", NATIVE)
def test_native_sources_match_their_origin(rel, origin):
    assert ((REPO / "gnsstpu_torch" / rel).read_bytes()
            == (REPO / origin).read_bytes()), (
        f"gnsstpu_torch/{rel} drifted from {origin}: copy it over")


def _both(mod: str):
    return (importlib.import_module(f"gnsstpu.{mod}"),
            importlib.import_module(f"gnsstpu_torch.{mod}"))


def test_copies_import_only_the_port():
    for rel in COPIES:
        src = (REPO / "gnsstpu_torch" / rel).read_text()
        assert not re.search(r"^\s*(from|import)\s+gnsstpu(\.|\s|$)", src,
                             re.M), rel


@pytest.mark.parametrize("signal", ["gps_l1ca", "galileo_e1b",
                                    "beidou_b1i", "glonass_l1of"])
def test_code_tables_bitwise(signal):
    jct, tct = _both("ops.code_tables")
    jsd = jct.get_signal(signal)
    tsd = tct.get_signal(signal)
    assert tsd is not jsd            # each package has its own registry
    fs = 4.2e6
    a = jct.sampled_code_table(signal, fs, jsd.code_freq, jsd.code_length)
    b = tct.sampled_code_table(signal, fs, tsd.code_freq, tsd.code_length)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jct.padded_code_table(signal),
                                  tct.padded_code_table(signal))


def test_lnav_encode_decode_parity():
    jl, tl = _both("nav.lnav")
    jt, tt = _both("nav.types")
    fields = dict(
        t_oc=266400.0, a_f0=2.45e-4, a_f1=-3.2e-12, a_f2=0.0,
        T_GD=-4.656e-9, sqrtA=5153.712, e=0.0123456, M_0=1.23456,
        deltan=4.2e-9, omega=-1.87654, omega_0=-2.0312,
        omegaDot=-8.1e-9, i_0=0.96123, iDot=4.0e-10, t_oe=266400.0,
        C_uc=-6.7e-7, C_us=8.1e-6, C_rc=221.5625, C_rs=-12.8125,
        C_ic=-7.45e-8, C_is=1.12e-7, valid=True)
    bj = jl.encode_frames(jt.Ephemeris(**fields), tow0=44400,
                          n_subframes=5)
    bt = tl.encode_frames(tt.Ephemeris(**fields), tow0=44400,
                          n_subframes=5)
    np.testing.assert_array_equal(bj, bt)
    jf, tf = _both("nav.frame")
    prompt = np.repeat(bj, 20) * 700.0
    sj = jf.find_preamble(prompt)
    st = tf.find_preamble(prompt.copy())
    assert sj.found and st.found
    assert sj.__dict__ == st.__dict__


def test_galileo_inav_encode_decode_parity():
    jg, tg = _both("nav.galileo")
    fields = dict(
        IODnav=61, t_oe=351000.0, M_0=0.654321, e=2.5e-4, sqrtA=5440.588,
        omega_0=-1.0471975, i_0=0.9773844, omega=0.5235988,
        iDot=-1.8e-10, omegaDot=-5.6e-9, deltan=3.2e-9,
        C_uc=-8.5e-7, C_us=9.9e-6, C_rc=112.25, C_rs=-27.125,
        SVID=11, C_ic=3.7e-8, C_is=-5.6e-8, t_oc=351000.0,
        a_f0=-1.2e-4, a_f1=-7.9e-12, a_f2=0.0,
        ai0=40.0, ai1=0.15, ai2=0.002, BGD_E1E5a=2.3e-9, BGD_E1E5b=2.8e-9,
        WN=1042, TOW=351000)
    sj = jg.encode_frames(jg.GalileoEphemeris(**fields), tow0=351000,
                          n_pages=5)
    stt = tg.encode_frames(tg.GalileoEphemeris(**fields), tow0=351000,
                           n_pages=5)
    np.testing.assert_array_equal(sj, stt)
    dj, towj = jg.decode_frames(sj * 900.0, 0)
    dt, towt = tg.decode_frames(stt * 900.0, 0)
    assert dj.valid and dt.valid and towj == towt == 351000
    assert dj.__dict__ == dt.__dict__


def test_pvt_lsq_parity():
    """Both packages' least squares on one geometry give the same fix."""
    jp, tp = _both("nav.pvt")
    recv = np.array([3427947.0, 603774.0, 5326967.0])
    rng = np.random.default_rng(2)
    sat = []
    for az, el in ((10, 70), (80, 35), (150, 25), (220, 50), (300, 20),
                   (45, 15)):
        az, el = np.radians(az), np.radians(el)
        u = np.array([np.cos(el) * np.sin(az), np.cos(el) * np.cos(az),
                      np.sin(el)])
        sat.append(recv + 2.2e7 * (u + 0.3 * rng.normal(size=3) * 0.01))
    sat = np.array(sat)
    clock_m = 1234.5
    pr = np.linalg.norm(sat - recv, axis=1) + clock_m + rng.normal(
        0, 1.0, len(sat))
    rj = jp.least_square_pos(sat.copy(), pr.copy(), use_tropo=False)
    rt = tp.least_square_pos(sat.copy(), pr.copy(), use_tropo=False)
    assert rj.ok and rt.ok
    assert np.linalg.norm(rt.pos[:3] - recv) < 20.0
    for name in ("pos", "el", "az", "dop", "residuals"):
        np.testing.assert_array_equal(getattr(rj, name), getattr(rt, name))


def _grid_navigate(**kw):
    """pvt.navigate's epoch grid without its arithmetic: a valid fix every
    solution period of the window from the latest anchor on, in window
    ms as navigate reports them."""
    period = kw["sig"].code_period_s
    step = int(round(kw["nav"].sol_period_ms * 1e-3 / period))
    t = np.arange(int(max(kw["subframe_start_ms"])), kw["n_ms"], step)
    t_ms = t * period * 1e3
    one = np.ones(len(t))
    return types.SimpleNamespace(
        t_ms=t_ms, valid=one > 0, x=one, y=one, z=one, latitude=one,
        longitude=one, height=one, n_sats=np.full(len(t), len(kw["prns"])),
        dop=np.ones((len(t), 5)), dt=0 * one, meas=[])


@pytest.mark.parametrize("pkg", ["gnsstpu", "gnsstpu_torch"])
def test_fixes_keep_the_managers_clock_when_a_channel_joins(
        pkg, monkeypatch):
    """Seven Galileo channels tracked from 0 ms, an eighth from 6,000 ms
    (found by a later search), every ephemeris anchored at the page that
    starts at 12,000 ms. After the eighth joins, the reference reports
    its fixes from the eighth's start, so their t_ms go back 6,000 ms
    and repeat earlier ones; the port reports every fix in the manager's
    clock (the port's deviation)."""
    navmod = importlib.import_module(f"{pkg}.runtime.navigator")
    cfg = importlib.import_module(f"{pkg}.config")
    tlm_mod = importlib.import_module(f"{pkg}.runtime.telemetry")
    monkeypatch.setattr(navmod.pvt, "navigate", _grid_navigate)
    sig = cfg.SignalConfig(signal="galileo_e1b", if_freq=0.0, fs=4.2e6,
                           code_freq=2.046e6, code_length=8184)
    nav = navmod.OnlineNavigator(sig, cfg.NavConfig(sol_period_ms=500))
    tlm = tlm_mod.Telemetry(sink=None)
    pvt_ms = []
    tlm.subscribe(lambda r: pvt_ms.append(r["epoch_ms"])
                  if r.get("type") == "pvt" else None)
    mgr = types.SimpleNamespace(
        tlm=tlm, slots=[], history={},
        sd=types.SimpleNamespace(bit_len_codes=1))
    period_ms = 4

    def track(prn, start_ms, now_ms):
        n = (now_ms - start_ms) // period_ms
        mgr.history[prn] = {"start_ms": start_ms, "evicted": 0,
                            "abs_sample": [np.arange(n, dtype=float)],
                            "carr_cycles": []}
        nav.decoded[prn] = ((12000 - start_ms) // period_ms, 351000.0, None)

    early = [5, 7, 14, 23, 24, 28, 30]
    mgr.slots = [types.SimpleNamespace(prn=p) for p in early]
    for p in early:
        track(p, 0, 14000)
    nav.poll(mgr, 14000)
    first = [s["t_ms"] for s in nav.solutions]
    assert first == [10000.0 + 500.0 * k for k in range(8)]
    mgr.slots.append(types.SimpleNamespace(prn=21))
    for p in early:
        track(p, 0, 18000)
    track(21, 6000, 18000)
    nav.poll(mgr, 18000)
    later = [s["t_ms"] for s in nav.solutions][len(first):]
    assert [s["n_sv"] for s in nav.solutions][len(first):] == [8] * 8
    assert pvt_ms == [int(t) for t in first + later]
    if pkg == "gnsstpu":
        assert later == [8000.0 + 500.0 * k for k in range(8)]
    else:
        assert later == [14000.0 + 500.0 * k for k in range(8)]
