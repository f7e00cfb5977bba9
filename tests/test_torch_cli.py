"""`python -m gnsstpu_torch track FILE`: the port's command line tracks an
IF file on the CPU (K1's plain twin) and writes telemetry, GLONASS L1OF
included, saves the channel bank (--checkpoint) and warm-restarts from it
(--resume); the options of parts not ported yet raise instead of being
ignored."""

import json

import numpy as np
import pytest

from gnsstpu.config import SignalConfig
from gnsstpu.sim import IFSimulator, SatParams
from gnsstpu_torch.__main__ import main
from torch_port import one_torch_thread_per_worker  # noqa: F401

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
ARGS = ["--device", "cpu", "--fs", "2.048e6", "--if-freq", "0",
        "--ms", "800", "--channels", "3", "--epoch-ms", "100",
        "--band", "6e3", "--threshold", "2.4", "--fine-doppler", "10",
        "--sync-every", "4"]


@pytest.fixture(scope="module")
def if_file(tmp_path_factory):
    sats = [SatParams(prn=5, doppler_hz=900.0, code_phase_chips=200.5,
                      cn0_dbhz=47.0),
            SatParams(prn=12, doppler_hz=-1500.0, code_phase_chips=700.25,
                      cn0_dbhz=46.0)]
    x = np.asarray(IFSimulator(SIG, sats, noise_sigma=1.0,
                               seed=3).generate(850))
    path = tmp_path_factory.mktemp("if") / "gps.i8"
    np.clip(np.round(x * 20.0), -127, 127).astype(np.int8).tofile(path)
    return str(path)


def test_track_file(if_file, tmp_path, capsys):
    log = tmp_path / "tlm.jsonl"
    assert main(["track", if_file, *ARGS, "--log", str(log)]) == 0
    assert "live PRNs at end: [5, 12]" in capsys.readouterr().out
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    starts = {r["prn"] for r in recs if r.get("what") == "channel_start"}
    assert starts == {5, 12}


@pytest.mark.parametrize("opt", ["--mesh", "--resume", "--listen",
                                 "--profile"])
def test_unported_options_raise(if_file, opt):
    """An option of a part not ported yet raises NotImplementedError;
    --resume is ported, and a checkpoint file that is not there raises."""
    err = FileNotFoundError if opt == "--resume" else NotImplementedError
    with pytest.raises(err, match="ROADMAP" if opt != "--resume" else "x"):
        main(["track", if_file, *ARGS, opt, "x"])


@pytest.fixture(scope="module")
def glonass_file(tmp_path_factory):
    """0.6 s of tests/test_glonass.py's live FDMA sky (6 satellites on
    their frequency channels) at 4.096 Msps, as 8-bit I/Q."""
    from gnsstpu.sim.scenario import (build_scenario_glonass,
                                      make_glonass_constellation)
    from test_glonass import GFIX_RECV, GFIX_T0, GFIX_TB

    sig = SignalConfig(signal="glonass_l1of", if_freq=0.0, fs=4.096e6,
                       code_freq=0.511e6, code_length=511,
                       fdma_step=562.5e3, complex_iq=True)
    gephs = make_glonass_constellation(GFIX_RECV, GFIX_TB, n=6)
    sats, _ = build_scenario_glonass(sig, gephs, GFIX_RECV, GFIX_T0,
                                     duration_s=1.0, cn0_dbhz=48.0)
    x = np.asarray(IFSimulator(sig, sats, noise_sigma=1.0,
                               seed=31).generate(600))
    path = tmp_path_factory.mktemp("if") / "glonass.i8"
    np.clip(np.round(x * 20.0), -127, 127).astype(np.int8).tofile(path)
    return str(path), sorted(gephs)


def test_track_glonass_checkpoint_resume(glonass_file, tmp_path, capsys):
    """FDMA acquisition + K1's twin on the CPU, the channel bank saved
    after 300 ms, then a warm restart from it that resumes every channel
    with no new channel start."""
    path, sky = glonass_file
    args = ["--device", "cpu", "--signal", "glonass_l1of", "--fs",
            "4.096e6", "--if-freq", "0", "--channels", "6", "--epoch-ms",
            "100"]
    bank = str(tmp_path / "bank.npz")
    log1, log2 = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    assert main(["track", path, *args, "--ms", "300", "--checkpoint", bank,
                 "--log", str(log1)]) == 0
    first = [json.loads(line) for line in log1.read_text().splitlines()]
    started = {r["prn"] for r in first if r.get("what") == "channel_start"}
    assert started == set(sky)
    assert main(["track", path, *args, "--ms", "200", "--resume", bank,
                 "--log", str(log2)]) == 0
    assert "live PRNs at end" in capsys.readouterr().out
    second = [json.loads(line) for line in log2.read_text().splitlines()]
    assert not [r for r in second if r.get("what") == "channel_start"]
    live = {r["prn"] for r in second if r.get("type") == "channel_health"}
    assert live == started
