"""`python -m gnsstpu_torch track FILE`: the port's command line tracks an
IF file on the CPU (K1's plain twin) and writes telemetry; the options of
parts not ported yet raise instead of being ignored."""

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


@pytest.mark.parametrize("opt", ["--mesh", "--resume", "--listen"])
def test_unported_options_raise(if_file, opt):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["track", if_file, *ARGS, opt, "x"])
