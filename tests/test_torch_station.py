"""The remote station on the port: a StationServer (the port's verbatim
copy of gnsstpu/runtime/remote.py) attached to the port's telemetry, with
StationSocket clients and GroundStation consoles (the copy of
gnsstpu/runtime/station.py) of both packages on loopback. The copies'
drift guard is tests/test_torch_copies.py's COPIES.

Socket and thread rules: port 0, every socket and server closed in a
`finally`, every wait bounded by a 20 s deadline (far above what it
needs, so that a loaded host does not trip it), nothing asserts a
wall-clock speed."""

import io
import json
import time

import numpy as np
import pytest

from gnsstpu.config import (AcqConfig, ReceiverConfig, SignalConfig,
                            TrackConfig)
from gnsstpu.runtime import remote as jremote
from gnsstpu.runtime import station as jstation
from gnsstpu.sim import IFSimulator, SatParams
from gnsstpu_torch.runtime import remote as tremote
from gnsstpu_torch.runtime import station as tstation
from gnsstpu_torch.runtime.manager import ChannelManager
from gnsstpu_torch.runtime.sources import PackedArraySource
from gnsstpu_torch.runtime.telemetry import Telemetry
from torch_port import one_torch_thread_per_worker, to_port  # noqa: F401

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
DEADLINE_S = 20.0


def _until(cond, what: str) -> None:
    t_end = time.monotonic() + DEADLINE_S
    while not cond():
        if time.monotonic() > t_end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _read_until(link, n: int) -> list:
    """At least n lines from a StationSocket (bounded wait)."""
    lines = []

    def more():
        lines.extend(link.read_lines())
        return len(lines) >= n or link.closed
    _until(more, f"{n} telemetry lines")
    return lines


def test_server_feeds_client_and_mask_reaches_manager():
    """The port's manager (CPU, K1's twin) with a StationServer on its
    telemetry and its commands: a client connected before the run gets
    the run's records, and its `mask` of an absent PRN is applied at the
    first epoch (command_ok, the PRN leaves the pool)."""
    sats = [SatParams(prn=5, doppler_hz=900.0, code_phase_chips=200.5,
                      cn0_dbhz=47.0)]
    x = np.asarray(IFSimulator(SIG, sats, noise_sigma=1.0,
                               seed=3).generate(650))
    cfg = to_port(ReceiverConfig(
        signal=SIG,
        acq=AcqConfig(doppler_band=6e3, coherent_ms=2, threshold=2.4,
                      prn_list=(5, 9), fine_doppler_ms=10),
        track=TrackConfig(dll_bw=1.0), n_channels=2))
    sink = io.StringIO()
    tlm = Telemetry(sink=sink)
    srv = tremote.StationServer()
    link = None
    try:
        srv.attach(tlm)
        link = tremote.StationSocket("127.0.0.1", srv.port)
        _until(lambda: srv.n_clients() == 1, "the client's accept")
        link.send_command({"cmd": "mask", "prn": 9})
        _until(lambda: srv.commands._q.qsize() == 1, "the command")
        mgr = ChannelManager(PackedArraySource(x, fmt="sm2"), cfg,
                             device="cpu", telemetry=tlm, epoch_ms=100,
                             commands=srv.commands, prn_pool=[5, 9],
                             sync_every=2)
        recs = mgr.run(600)
        n_sent = len(sink.getvalue().splitlines())
        lines = _read_until(link, n_sent)
    finally:
        if link is not None:
            link.close()
        srv.close()
    assert mgr.pool == [5]
    assert int(recs[-1].prn[0]) == 5
    got = [json.loads(line) for line in lines]
    assert got == [json.loads(line) for line in sink.getvalue().splitlines()]
    types = {r["type"] for r in got}
    assert {"channel_health", "event", "task_health"} <= types
    ok = [r for r in got if r.get("what") == "command_ok"]
    assert len(ok) == 1 and ok[0]["epoch_ms"] == 0 and "mask" in ok[0]["raw"]


RECORDS = [
    {"type": "event", "epoch_ms": 0, "what": "channel_start", "chan": 0,
     "prn": 5},
    {"type": "channel_health", "epoch_ms": 100, "chan": 0, "prn": 5,
     "cn0_dbhz": 46.5, "doppler_hz": 901.0, "pll_lock": 0.9,
     "state": "tracking", "ip_abs": 800.0, "qp_abs": 40.0},
    {"type": "pvt", "epoch_ms": 1000, "lat_deg": 57.0, "lon_deg": 10.0,
     "h_m": 25.0, "n_sv": 5},
]


@pytest.mark.parametrize("server,client", [(tremote, jremote),
                                           (jremote, tremote)],
                         ids=["port-server", "reference-server"])
def test_wire_compatible_with_reference(server, client):
    """One protocol: the port's server with the reference's client and
    the reference's server with the port's client carry the same lines
    down and the same command up."""
    srv = server.StationServer()
    link = None
    try:
        link = client.StationSocket("127.0.0.1", srv.port)
        _until(lambda: srv.n_clients() == 1, "the client's accept")
        for rec in RECORDS:
            srv.send(rec)
        lines = _read_until(link, len(RECORDS))
        link.send_command({"cmd": "drop", "prn": 5})
        cmds = []
        _until(lambda: cmds.extend(srv.commands.poll()) or cmds,
               "the command")
    finally:
        if link is not None:
            link.close()
        srv.close()
    assert [json.loads(line) for line in lines] == RECORDS
    assert cmds == [{"cmd": "drop", "prn": 5}]


def test_ground_station_over_tcp():
    """Both packages' GroundStation on one port StationServer: each
    ingests the same records, renders the same pages, and an operator's
    `mask 9` reaches the server's command queue."""
    srv = tremote.StationServer()
    stations = {}
    try:
        url = f"tcp://127.0.0.1:{srv.port}"
        stations = {"ref": jstation.GroundStation(url),
                    "port": tstation.GroundStation(url)}
        for st in stations.values():
            assert st.pump() == 0          # connects
        _until(lambda: srv.n_clients() == 2, "both stations' accept")
        for rec in RECORDS:
            srv.send(rec)
        for st in stations.values():
            n = [0]

            def got_all(st=st, n=n):
                n[0] += st.pump()
                return n[0] >= len(RECORDS)
            _until(got_all, "the records")
        pages = {}
        for name, st in stations.items():
            pages[name] = []
            for i in range(len(st.PAGES)):
                st.handle_key(str(i + 1))
                pages[name].append(st.render())
        assert stations["port"].submit("mask 9")
        cmds = []
        _until(lambda: cmds.extend(srv.commands.poll()) or cmds,
               "the command")
    finally:
        for st in stations.values():
            if st._link is not None:
                st._link.close()
        srv.close()
    assert pages["port"] == pages["ref"]
    assert "901" in pages["port"][0]
    assert cmds == [{"cmd": "mask", "prn": 9}]
    assert tremote.parse_tcp_url("tcp://:7700") == ("127.0.0.1", 7700)
    assert tremote.parse_tcp_url("telemetry.jsonl") is None
    assert tstation.sparkline([0, 5, 10], 0, 10, width=3) == "▁▄█"
