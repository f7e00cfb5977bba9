"""`python -m gnsstpu_torch`: the port's command line on the CPU (K1's
plain twin). `track FILE` writes telemetry, GLONASS L1OF included, saves
the channel bank (--checkpoint) and warm-restarts from it (--resume);
`track --listen` takes a radio's packed bytes over TCP with a station
server and a profiler trace; `track FILE --source-fs` resamples the file
(also streamed, --stream); `monitor LOG` renders the reference's board;
`simulate` writes a file that `track` and `acquire` find the sky in;
`solve FILE` prints the reference's acquisition and decode lines and exit
code; `analyze LOG` writes the reference's panels; `track --mesh
channel=2` shards the receiver and logs what the unsharded run logs;
`bench` runs gnsstpu_torch.bench.main, and without a card raises before
measuring anything."""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("opt", ["--mesh", "--resume"])
def test_unported_options_raise(if_file, opt, tmp_path):
    """--mesh channel=2 runs the receiver sharded over two CPU devices
    (4 channels) and its telemetry records equal the same run's without
    --mesh; --resume with a checkpoint file that is not there raises."""
    if opt == "--resume":
        with pytest.raises(FileNotFoundError, match="x"):
            main(["track", if_file, *ARGS, opt, "x"])
        return
    logs = []
    for extra in ([], ["--mesh", "channel=2"]):
        log = tmp_path / f"tlm{len(logs)}.jsonl"
        assert main(["track", if_file, *ARGS, "--channels", "4",
                     "--ms", "400", "--log", str(log), *extra]) == 0
        logs.append([json.loads(line)
                     for line in log.read_text().splitlines()])
    # Every record but its wall-clock stamp, and the stage timings.
    strip = [[{k: v for k, v in r.items() if k != "t"}
              for r in recs if r.get("type") != "task_health"]
             for recs in logs]
    assert len(strip[0]) > 0
    assert strip[0] == strip[1]


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


REPO = Path(__file__).resolve().parents[1]


def test_track_listen_tcp(tmp_path):
    """tests/test_stream.py's CLI case on the port: `track --listen tcp:0
    --listen-fmt sm2` as a subprocess takes a radio's packed 2-bit bytes
    from a TCP sender and tracks, with a station server (a client reads
    its records)."""
    from gnsstpu.ops import unpack as up
    from gnsstpu_torch.runtime.remote import StationSocket

    sats = [SatParams(prn=6, doppler_hz=-1100.0, code_phase_chips=512.5,
                      cn0_dbhz=47.0)]
    samples = np.asarray(IFSimulator(SIG, sats, noise_sigma=1.0,
                                     seed=12).generate(940))
    wire = up.pack(samples, "sm2", scale=1.0).tobytes()
    # One torch thread: beside a parallel test run, a thread pool in the
    # subprocess oversubscribes the host's cores.
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gnsstpu_torch", "track", "--device", "cpu",
         "--listen", "tcp:0", "--listen-fmt", "sm2", "--station-port", "0",
         "--log", str(tmp_path / "tlm.jsonl"),
         "--fs", "2.048e6", "--if-freq", "0", "--ms", "800", "--band",
         "6e3", "--threshold", "2.4", "--channels", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(REPO), env=env)
    link = None
    try:
        ports = {}
        for _ in range(50):
            line = proc.stderr.readline()
            for key, tag in (("listen", "listening for IF samples on"),
                             ("station", "station server on")):
                if tag in line:
                    ports[key] = int(line.split(tag)[1].split(":")[2]
                                     .split()[0])
            if len(ports) == 2:
                break
        assert len(ports) == 2, f"no banners: {ports}"
        link = StationSocket("127.0.0.1", ports["station"])
        tx = socket.create_connection(("127.0.0.1", ports["listen"]),
                                      timeout=10)
        try:
            tx.sendall(wire)
        finally:
            tx.close()
        out, err = proc.communicate(timeout=300)
        lines = []
        for _ in range(100):
            lines += link.read_lines()
            if link.closed:
                break
            time.sleep(0.05)
    finally:
        if link is not None:
            link.close()
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    assert "live PRNs at end: [6]" in out, (out, err)
    recs = [json.loads(line) for line in lines]
    assert any(r["type"] == "channel_health" and r["prn"] == 6
               for r in recs)


def test_profile_writes_a_chrome_trace(tmp_path):
    """`--profile DIR` runs the manager under torch.profiler and writes
    DIR/trace.json (on the card it names K1's kernel: chip_smoke.py phase
    21). A stand-in manager keeps the CPU trace small."""
    import torch

    from gnsstpu_torch.__main__ import _run_profiled

    class Manager:
        device = torch.device("cpu")

        def run(self, n_ms):
            x = torch.ones(n_ms)
            return [float(torch.cumsum(x, 0)[-1])]

    assert _run_profiled(Manager(), 64, str(tmp_path / "p")) == [64.0]
    events = json.loads((tmp_path / "p" / "trace.json").read_text())[
        "traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


@pytest.fixture(scope="module")
def hi_rate_file(tmp_path_factory):
    """1 s of a 2-SV sky at 4.096 Msps, 8-bit I/Q."""
    sig_in = SignalConfig(if_freq=0.0, fs=4.096e6, complex_iq=True)
    sats = [SatParams(prn=5, doppler_hz=900.0, code_phase_chips=200.5,
                      cn0_dbhz=47.0),
            SatParams(prn=12, doppler_hz=-1500.0, code_phase_chips=700.25,
                      cn0_dbhz=46.0)]
    x = np.asarray(IFSimulator(sig_in, sats, noise_sigma=1.0,
                               seed=3).generate(1000))
    path = tmp_path_factory.mktemp("if") / "hi_rate.i8"
    np.clip(np.round(x * 18.0), -127, 127).astype(np.int8).tofile(path)
    return str(path)


@pytest.mark.parametrize("stream", [[], ["--stream"]],
                         ids=["file", "stream"])
def test_track_source_fs(hi_rate_file, stream, capsys):
    """`track FILE --source-fs 4.096e6 --fs 2.048e6` resamples the file to
    the receiver's rate (polyphase, on the CPU here) and tracks both SVs,
    read directly or streamed through the producer thread and the FIFO."""
    assert main(["track", hi_rate_file, *ARGS, "--source-fs", "4.096e6",
                 *stream]) == 0
    out = capsys.readouterr().out
    live = json.loads(out.rsplit("live PRNs at end: ", 1)[1])
    assert sorted(live) == [5, 12]


def test_monitor_log_matches_reference(if_file, tmp_path, capsys):
    """`monitor LOG` of a port track run prints the reference's board
    (`gnsstpu.cli.main(["monitor", LOG])`) on every page."""
    from gnsstpu.cli import main as jmain

    log = str(tmp_path / "tlm.jsonl")
    assert main(["track", if_file, *ARGS, "--navigate", "--log", log]) == 0
    capsys.readouterr()
    for page in ("channels", "health", "events", "all"):
        assert main(["monitor", log, "--page", page]) == 0
        port = capsys.readouterr().out
        assert jmain(["monitor", log, "--page", page]) == 0
        assert port == capsys.readouterr().out
        assert port.strip()


def test_simulate_round_trip(tmp_path, capsys):
    """`simulate OUT` writes an i8_iq file; `acquire OUT` and `track OUT`
    find its PRNs. (The two packages' simulators draw noise from other
    generators, so the bytes are not compared with the reference's.)"""
    out = str(tmp_path / "sim.i8")
    sig = ["--device", "cpu", "--fs", "2.048e6", "--if-freq", "0"]
    assert main(["simulate", out, *sig, "--ms", "900", "--seed", "7",
                 "--sat", "3:1200:100.5:47", "--sat",
                 "17:-700:800.25:47"]) == 0
    assert "wrote 900 ms" in capsys.readouterr().out
    assert main(["acquire", out, *sig, "--band", "6e3", "--threshold",
                 "2.4"]) == 0
    found = [json.loads(line) for line in
             capsys.readouterr().out.splitlines()]
    det = {r["prn"]: r for r in found if r["detected"]}
    assert set(det) == {3, 17}
    assert abs(det[3]["carr_freq_hz"] - 1200.0) < 300.0
    assert main(["track", out, *ARGS]) == 0
    assert "live PRNs at end: [3, 17]" in capsys.readouterr().out


def test_solve_matches_reference(if_file, capsys):
    """`solve FILE` of both packages on the same short file (0.8 s: two
    SVs acquired, no subframe, no fix): the same `acquired:` and
    `ephemerides decoded:` lines and the same exit code."""
    from gnsstpu.cli import main as jmain

    args = ["--fs", "2.048e6", "--if-freq", "0", "--ms", "800",
            "--channels", "3", "--band", "6e3", "--threshold", "2.4"]
    outs = []
    for fn, extra in ((main, ["--device", "cpu"]), (jmain, [])):
        rc = fn(["solve", if_file, *args, *extra])
        lines = capsys.readouterr().out.splitlines()
        outs.append((rc, [ln for ln in lines
                          if ln.startswith(("acquired:", "ephemerides"))],
                     lines[-1]))
    assert outs[0] == outs[1]
    assert outs[0] == (1, ["acquired: [5, 12]", "ephemerides decoded: []"],
                       "no position fix")


def test_analyze_writes_the_reference_panels(if_file, tmp_path, capsys):
    """`analyze LOG --out DIR` of both packages on one telemetry log (a
    port `track --navigate` run) writes the same files and says so."""
    from gnsstpu.cli import main as jmain

    log = str(tmp_path / "tlm.jsonl")
    assert main(["track", if_file, *ARGS, "--navigate", "--log", log]) == 0
    capsys.readouterr()
    said = []
    for fn, sub in ((main, "port"), (jmain, "ref")):
        out = tmp_path / sub
        assert fn(["analyze", log, "--out", str(out)]) == 0
        said.append([ln.replace(str(out), "DIR") for ln in
                     capsys.readouterr().out.splitlines()])
        assert sorted(p.name for p in out.iterdir()) == sorted(
            ln.rsplit("/", 1)[1] for ln in said[-1])
    assert said[0] == said[1]
    assert "wrote DIR/health.png" in said[0]
    assert os.path.getsize(tmp_path / "port" / "health.png") > 0


def test_bench_dispatches_to_the_bench_module(monkeypatch):
    """`bench` is registered, as in the reference's CLI, and runs
    gnsstpu_torch.bench.main on --device (the card by default)."""
    from gnsstpu_torch import bench

    calls = []
    monkeypatch.setattr(bench, "main", lambda device: calls.append(device))
    assert main(["bench", "--device", "cpu"]) == 0
    assert main(["bench"]) == 0
    assert calls == ["cpu", "cuda"]


def test_bench_without_a_card_raises_first(monkeypatch):
    """`bench` on the card without one raises before any measurement
    (a host with a card is made to look like one without)."""
    from gnsstpu_torch import bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    for name in ("bench_tracking", "bench_acquisition", "bench_manager"):
        monkeypatch.setattr(bench, name,
                            lambda *a, name=name, **k: ran.append(name))
    with pytest.raises(RuntimeError, match="is_available"):
        main(["bench"])
    assert ran == []
