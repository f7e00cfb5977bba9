"""The plain reference against the generator's truth, and the comparison
against outputs that are right, one precision step down, and corrupted on
purpose; the Galileo E1B ephemeris check against the port's I/NAV decoder;
and the judged numbers of the two cells pinned as they were before each
signal became a module of its own (signals/<signal>.py)."""

import copy

import numpy as np
import pytest

from gnsstpu_torch.nav import galileo as pgal

from portbench import control, plan
from portbench.gen import ifsim
from portbench.gen import sky as skymod
from portbench.reference import compare, truth

DATA = plan.HERE / "tests" / "data"
CELLS = ["gps_l1ca_12ch.hostfed_44s", "glonass_l3oc_12ch.resident_9s"]
GAL_CELL = "galileo_e1b_12ch.galileo_20s"


def _cell(name, base=plan.HERE):
    """(configuration, traffic) of a cell named <config>.<traffic>."""
    cfg, tr = name.split(".")
    return (plan.load_json(base / "configs" / f"{cfg}.json"),
            plan.load_json(base / "traffic" / f"{tr}.json"))


@pytest.mark.parametrize("name,base", [(c, plan.HERE) for c in CELLS]
                         + [(GAL_CELL, DATA)])
def test_truth_code_periods_are_where_the_generator_put_them(name, base):
    """Noise-free samples correlated with each stream's code over the
    periods the reference says end at its code starts: full correlation
    there and its symbol's sign; half a chip off, far less."""
    cfg, tr = _cell(name, base)
    sky = skymod.make_sky(cfg, tr, 424242)
    sky.sats = sky.sats[:2]
    sim = ifsim.IFSim(sky, noise_sigma=1.0, seed=0, device="cpu")
    sim.noise_sigma = 0.0
    x = sim.generate(6 * cfg["signal"]["code_period_ms"]).numpy().astype(
        np.float64)
    x = x[:, 0] + 1j * x[:, 1]
    sig = sky.signal
    spc = sig.samples_per_code
    for sat in sky.sats:
        st = truth.streams_of(sky)[sat.prn]
        ends = st.code_starts(2.0 * spc, 3)
        amp = np.sqrt(10 ** (sat.cn0_dbhz / 10) / sig.fs)
        for e in ends[1:]:
            n = np.arange(int(np.ceil(e - spc)), int(np.floor(e)))
            t = n / sig.fs
            chips = st.chips(n)
            rep = sig.code(sat.prn)[np.floor(np.mod(chips, sig.code_length))
                                    .astype(int)]
            f = sig.if_freq + sat.doppler_hz
            carr = np.exp(1j * (2 * np.pi * (f * t + 0.5 * sat.doppler_rate
                                             * t * t) + sat.carrier_phase))
            corr = np.sum(x[n] * rep * np.conj(carr)).real / (amp * len(n))
            sym = st.symbols([e])[0]
            assert corr == pytest.approx(sym, abs=0.02)
            off = st.chips(n) + 0.5
            rep2 = sig.code(sat.prn)[np.floor(np.mod(off, sig.code_length))
                                     .astype(int)]
            corr2 = np.sum(x[n] * rep2 * np.conj(carr)).real / (amp * len(n))
            assert abs(corr2) < 0.6


@pytest.mark.parametrize("name", CELLS)
def test_reference_in_the_programs_place_is_correct(name):
    r = control.readings(*_cell(name), 7)
    assert r["stated"][0], r["stated"][1]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 5])
def test_control_one_precision_step_down_is_not_correct(name, seed):
    ok, rows = control.readings(*_cell(name), seed)["control"]
    assert not ok
    failed = {k for k, v, lim in rows if v > lim and k != "passes_judged"}
    assert {"doppler_err_hz", "code_err_m"} <= failed


def _ideal(name, seed=11):
    cfg, tr = _cell(name)
    sky = skymod.make_sky(cfg, tr, seed)
    p = control.ideal_pass(sky, cfg, tr["recording_ms"], "float32",
                           "float64")
    return cfg, sky, p


def _judge(cfg, sky, p):
    return compare.verdict(compare.judge(sky, [p], cfg), cfg["limits"], 1)


@pytest.mark.parametrize("name", CELLS)
def test_a_flipped_symbol_fails(name):
    cfg, sky, p = _ideal(name)
    assert _judge(cfg, sky, p)[0]
    bad = copy.deepcopy(p)
    ip = bad.history[sky.prns[0]]["i_p"][0]
    ip[5000:5020] *= -1                   # one 20 ms LNAV bit
    ok, rows = _judge(cfg, sky, bad)
    assert not ok and dict((k, v) for k, v, _ in rows)["symbol_errors"] == 20


@pytest.mark.parametrize("name", CELLS)
def test_a_doppler_one_bin_off_fails(name):
    cfg, sky, p = _ideal(name)
    step = cfg["acq"].get("doppler_step", 500.0 / cfg["acq"]["coherent_ms"])
    bad = copy.deepcopy(p)
    d = bad.history[sky.prns[-1]]["carr_doppler"][0]
    d[6000:6500] += step
    ok, rows = _judge(cfg, sky, bad)
    assert not ok
    assert dict((k, v) for k, v, _ in rows)["doppler_err_hz"] > 100


@pytest.mark.parametrize("name", CELLS)
def test_a_code_start_one_sample_late_fails(name):
    cfg, sky, p = _ideal(name)
    bad = copy.deepcopy(p)
    bad.history[sky.prns[1]]["abs_sample"][0][3000:3500] += 3.0
    assert not _judge(cfg, sky, bad)[0]


def test_missing_and_false_satellites_fail():
    cfg, sky, p = _ideal(CELLS[0])
    bad = copy.deepcopy(p)
    bad.events = bad.events[1:]
    assert not _judge(cfg, sky, bad)[0]
    bad = copy.deepcopy(p)
    bad.events.append({"type": "event", "what": "channel_confirmed",
                       "prn": sky.absent[0]})
    assert not _judge(cfg, sky, bad)[0]


def test_a_wrong_ephemeris_field_and_a_missing_fix_fail():
    cfg, sky, p = _ideal(CELLS[0])
    bad = copy.deepcopy(p)
    prn = sorted(bad.decoded)[0]
    bad.decoded[prn][2].e += 2.0 ** -33
    assert not _judge(cfg, sky, bad)[0]
    bad = copy.deepcopy(p)
    bad.solutions = []
    assert not _judge(cfg, sky, bad)[0]


@pytest.mark.parametrize("fault", ["a_chip_off", "stopped"])
def test_a_fix_off_and_fixes_that_stop_fail(fault):
    cfg, sky, p = _ideal(CELLS[0])
    bad = copy.deepcopy(p)
    if fault == "a_chip_off":            # one satellite's range off
        bad.solutions[3]["x"] += 293.0
        key = "fix_err_m"
    else:                                # the navigator stops after 5
        bad.solutions = bad.solutions[:5]
        key = "fixes_missing"
    ok, rows = _judge(cfg, sky, bad)
    nums = {k: v for k, v, _ in rows}
    assert not ok and nums[key] > cfg["limits"][key], nums


def test_broadcast_values_wrap_and_round():
    assert truth.broadcast_value(-3.0 * 2 ** -5, 2 ** -5, 16, True, False) \
        == -3.0 * 2 ** -5
    assert truth.broadcast_value(0.4 * 2 ** -31, 2 ** -31, 8, True, False) \
        == 0.0
    assert truth.broadcast_value(np.pi / 2, 2 ** -31, 32, True, True) \
        == pytest.approx(np.pi / 2, abs=2 ** -31 * np.pi)


def _galileo_decoded(seed):
    """The Galileo sky of a seed and what the port's I/NAV decoder reads
    from each satellite's symbols after the 2 s of lead symbols."""
    cfg, tr = _cell(GAL_CELL, DATA)
    sky = skymod.make_sky(cfg, tr, seed)
    decoded = {}
    for sat in sky.sats:
        eph, tow = pgal.decode_frames(sat.nav_bits[500:] * 800.0, 0)
        assert eph.valid and tow is not None
        decoded[sat.prn] = (0, float(tow), eph)
    return sky, decoded


@pytest.mark.parametrize("field,lsb", [
    ("M_0", 2.0 ** -31 * 3.1415926535898), ("a_f0", 2.0 ** -34),
    ("t_oe", 60.0), ("IODnav", 1)])
def test_galileo_ephemeris_read_by_the_ports_decoder(field, lsb):
    """Every field the port's decoder reads from the generator's pages is
    the broadcast one; one field one LSB off is an error."""
    sky, decoded = _galileo_decoded(2 ** 31 + 21)
    assert compare.eph_errors(decoded, sky) == 0
    eph = decoded[sky.prns[2]][2]
    setattr(eph, field, getattr(eph, field) + lsb)
    assert compare.eph_errors(decoded, sky) == 1
    del decoded[sky.prns[0]]
    assert compare.eph_errors(decoded, sky) == 2


#: compare.judge's numbers on fixed synthetic passes of each cell's sky at
#: seed 11: the reference in the program's place at the stated precision,
#: one step below it (control.py), and the stated one with faults planted
#: (a flipped bit, a Doppler 3 Hz off and a code start a sample late on
#: one track, a confirmation and an ephemeris missing, and the fixes
#: stopped after five, one moved 293 m).
JUDGED = {
    ("gps_l1ca_12ch", "hostfed_44s"): {
        "stated": {"missed_sats": 0, "false_sats": 0,
                   "doppler_err_hz": 2.4545055639464407e-06,
                   "code_err_m": 6.550228359762175e-08, "symbol_errors": 0,
                   "eph_errors": 0, "fix_err_m": 0.0, "passes_no_fix": 0,
                   "fixes_missing": 0},
        "control": {"missed_sats": 0, "false_sats": 0,
                    "doppler_err_hz": 7.93355919995271,
                    "code_err_m": 480.84337163636513, "symbol_errors": 0,
                    "eph_errors": 88, "fix_err_m": 0.0, "passes_no_fix": 0,
                    "fixes_missing": 0},
        "faulted": {"missed_sats": 1, "false_sats": 0,
                    "doppler_err_hz": 3.000000026810949,
                    "code_err_m": 146.38274459688623, "symbol_errors": 20,
                    "eph_errors": 1, "fix_err_m": 293.0, "passes_no_fix": 0,
                    "fixes_missing": 18}},
    ("glonass_l3oc_12ch", "hostfed_9s"): {
        "stated": {"missed_sats": 0, "false_sats": 0,
                   "doppler_err_hz": 1.7403006941094645e-06,
                   "code_err_m": 2.0960730751238962e-08, "symbol_errors": 0},
        "control": {"missed_sats": 0, "false_sats": 0,
                    "doppler_err_hz": 4.551152481476196,
                    "code_err_m": 64.50748960874787, "symbol_errors": 0},
        "faulted": {"missed_sats": 1, "false_sats": 0,
                    "doppler_err_hz": 2.9999998595690642,
                    "code_err_m": 12.491379157318923, "symbol_errors": 20}},
}


@pytest.mark.parametrize("cell", sorted(JUDGED))
def test_the_cells_judged_numbers_are_pinned(cell):
    cfg, tr = _cell(".".join(cell))
    sky = skymod.make_sky(cfg, tr, 11)
    n_ms = tr["recording_ms"]
    got = {}
    for tag, dev, host in (("stated", "float32", "float64"),
                           ("control", "bfloat16", "float32")):
        p = control.ideal_pass(sky, cfg, n_ms, dev, host)
        got[tag] = compare.judge(sky, [p], cfg)
    p = control.ideal_pass(sky, cfg, n_ms, "float32", "float64")
    h = p.history[sky.prns[0]]
    h["i_p"][0][5000:5020] *= -1
    h["carr_doppler"][0][6000:6500] += 3.0
    h["abs_sample"][0][3000:3500] += 1.0
    p.events = p.events[1:]
    if p.decoded:
        del p.decoded[sky.prns[1]]
        p.solutions = p.solutions[:5]
        p.solutions[3]["x"] += 293.0
    got["faulted"] = compare.judge(sky, [p], cfg)
    assert got == JUDGED[cell]
