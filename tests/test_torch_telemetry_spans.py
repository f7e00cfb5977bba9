"""The port's spans (runtime/telemetry.py Telemetry.span) on the CPU.

The primitive times its body whether tracing is on or off; off, it keeps
no record and enters no profiler range. A ChannelManager run (2 SVs, 3
channels, 800 ms, sync_every 4, K1's plain twin, the online navigator),
pipelined or not, emits the same telemetry with tracing off and on; on,
every superepoch has its spans under one key, the task_health walls are
the spans' walls, and under torch.profiler each nesting span is one
gnss.<name> range of its duration. `track --profile DIR` writes the
spans beside the trace. The search spans count the code rows searched
and whether pilot and data powers were summed (GPS and a small L3OC
run); K1's and K3's CUDA events become the superepoch's counters; each
upload counts the samples the wire table decoded, and on the CPU stages
nothing through the pinned ring.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from gnsstpu_torch.__main__ import _run_profiled, main
from gnsstpu_torch.config import (AcqConfig, NavConfig, ReceiverConfig,
                                  SignalConfig, TrackConfig)
from gnsstpu_torch.ops import track_kernel, unpack
from gnsstpu_torch.runtime.manager import ChannelManager
from gnsstpu_torch.runtime.navigator import OnlineNavigator
from gnsstpu_torch.runtime.sources import ArraySource, PackedArraySource
from gnsstpu_torch.runtime.telemetry import Telemetry
from gnsstpu_torch.signals import glonass_l3
from gnsstpu_torch.sim import IFSimulator, SatParams
from torch_port import one_torch_thread_per_worker  # noqa: F401

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
SATS = [SatParams(prn=5, doppler_hz=900.0, code_phase_chips=200.5,
                  cn0_dbhz=47.0),
        SatParams(prn=12, doppler_hz=-1500.0, code_phase_chips=700.25,
                  cn0_dbhz=46.0)]
#: task_health fields that are wall times.
WALLS = ("t", "wall_s", "read_s")


@pytest.fixture(scope="module")
def samples():
    return IFSimulator(SIG, SATS, noise_sigma=1.0, seed=3,
                       device="cpu").generate(850)


def _cfg():
    return ReceiverConfig(
        signal=SIG,
        acq=AcqConfig(doppler_band=6e3, coherent_ms=2, threshold=2.4,
                      prn_list=(5, 12), fine_doppler_ms=10),
        track=TrackConfig(dll_bw=1.0), nav=NavConfig(), n_channels=3)


def _run(samples, trace: bool, prefetch: bool, wire: str = "sm2"):
    """(telemetry records, Telemetry) of one 800 ms run, fed packed in
    the wire format (None: f32 samples)."""
    recs = []
    tlm = Telemetry(trace=trace)
    tlm.subscribe(recs.append)
    src = ArraySource(samples) if wire is None \
        else PackedArraySource(samples, fmt=wire)
    mgr = ChannelManager(
        src, _cfg(), device="cpu",
        telemetry=tlm, epoch_ms=100, reacq_period_ms=400,
        cn0_drop_dbhz=35.0, prn_pool=[5, 12], sync_every=4,
        engine="fused", prefetch=prefetch,
        readback="compact" if prefetch else "f32",
        navigator=OnlineNavigator(SIG, NavConfig()))
    mgr.run(800)
    return recs, tlm


def _self_ns(spans: list) -> dict:
    """Each nesting span's duration less its children's on its thread."""
    out = {s["id"]: s["t1_ns"] - s["t0_ns"] for s in spans
           if s["name"] != "superepoch"}
    for s in spans:
        if s["parent"] in out and s["name"] != "superepoch":
            by = next(p for p in spans if p["id"] == s["parent"])
            if by["thread"] == s["thread"]:
                out[s["parent"]] -= s["t1_ns"] - s["t0_ns"]
    return out


@pytest.mark.parametrize("trace", [False, True])
def test_span_primitive(trace, monkeypatch):
    """Off: walls, no record, no profiler range. On: every span opened
    is closed, once; parents are spans of the run (the enclosing span on
    the thread, else the superepoch of the span's key); keys and
    counters are kept; self times are not negative."""
    entered = []

    class Range:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr(torch.profiler, "record_function", Range)
    tlm = Telemetry(trace=trace)
    sup = tlm.open_span("superepoch", se=500)
    with tlm.span("outer", se=500, n=1) as outer:
        with tlm.span("inner") as inner:
            tlm.count(n=2)
            time.sleep(0.002)

    def reader():
        with tlm.span("feed.read", se=500):
            pass

    th = threading.Thread(target=reader, name="gnss-feed_0")
    th.start()
    th.join()
    tlm.close_span(sup, k1_device_ns=7)
    tlm.count(n=5)                   # no span open: nothing to add to
    assert inner.wall_s >= 0.002
    assert outer.wall_s >= inner.wall_s
    if not trace:
        assert tlm.spans == [] and entered == []
        return
    spans = tlm.spans
    by = {s["name"]: s for s in spans}
    assert sorted(by) == ["feed.read", "inner", "outer", "superepoch"]
    assert len({s["id"] for s in spans}) == 4
    assert entered == ["gnss.outer", "gnss.inner", "gnss.feed.read"]
    assert by["inner"]["parent"] == by["outer"]["id"]
    assert by["outer"]["parent"] == by["superepoch"]["id"]
    assert by["feed.read"]["parent"] == by["superepoch"]["id"]
    assert by["superepoch"]["parent"] is None
    assert {s["se"] for s in spans} == {500}
    assert by["feed.read"]["thread"] == "gnss-feed_0"
    assert by["inner"]["counters"] == {"n": 2}
    assert by["outer"]["counters"] == {"n": 1}
    assert by["superepoch"]["counters"] == {"k1_device_ns": 7}
    assert all(s["t1_ns"] >= s["t0_ns"] for s in spans)
    assert min(_self_ns(spans).values()) >= 0


def test_spans_from_many_threads():
    """Threads that open and close spans at once, switching often: every
    span is kept, once, under its own id and thread, with its parent."""
    import sys

    tlm = Telemetry(trace=True)
    n_threads, n_spans = 16, 300

    def work():
        for _ in range(n_spans):
            with tlm.span("outer", se=0):
                with tlm.span("inner"):
                    tlm.count(n=1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, name=f"w{i}")
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    spans = tlm.spans
    assert len(spans) == 2 * n_threads * n_spans
    assert len({s["id"] for s in spans}) == len(spans)
    outer = {s["id"]: s["thread"] for s in spans if s["name"] == "outer"}
    inner = [s for s in spans if s["name"] == "inner"]
    assert all(outer[s["parent"]] == s["thread"] and s["counters"] ==
               {"n": 1} for s in inner)


@pytest.mark.parametrize("prefetch", [False, True])
def test_manager_spans(samples, prefetch, monkeypatch):
    """The records are the same with tracing off and on (walls aside).
    On: each superepoch has superepoch, dispatch, harvest.wait
    (pipelined; else readback) and supervise under one key; the reader
    and fetch threads' spans carry it; the walls of track, readback,
    assess and pvt are those of dispatch, harvest.wait / readback,
    supervise and nav.poll; each poll splits into nav.decode,
    nav.almanac and nav.solve. Off, K1 is never given a list for
    timing events."""
    sinks = []
    timed = track_kernel.timed_launches

    def spy(events):
        sinks.append(events)
        return timed(events)

    monkeypatch.setattr(track_kernel, "timed_launches", spy)
    off, tlm_off = _run(samples, False, prefetch)
    assert sinks and all(e is None for e in sinks)
    sinks.clear()
    on, tlm = _run(samples, True, prefetch)
    assert sinks and all(e == [] for e in sinks)    # no CUDA launches
    strip = [[{k: v for k, v in r.items() if k not in WALLS} for r in recs]
             for recs in (off, on)]
    assert strip[0] == strip[1]
    assert tlm_off.spans == []

    spans = tlm.spans
    ids = {s["id"] for s in spans}
    assert len(ids) == len(spans)
    assert all(s["parent"] is None or s["parent"] in ids for s in spans)
    assert min(_self_ns(spans).values()) >= 0
    sup = {s["se"]: s for s in spans if s["name"] == "superepoch"}
    health = [r for r in on if r["type"] == "task_health"]
    tracks = [r["epoch_ms"] for r in health if r["stage"] == "track"]
    assert sorted(sup) == tracks and len(tracks) == 2
    wait = "harvest.wait" if prefetch else "readback"
    for se, s in sup.items():
        mine = [x["name"] for x in spans if x["se"] == se]
        for name in ("dispatch", wait, "supervise"):
            assert mine.count(name) == 1, (se, name, mine)
        assert "harvest.wait" not in mine or prefetch
    threads = {x["thread"] for x in spans}
    if prefetch:
        assert any(t.startswith("gnss-feed") for t in threads)
        assert any(t.startswith("gnss-fetch") for t in threads)
    for x in spans:
        if x["thread"].startswith(("gnss-feed", "gnss-fetch")):
            assert x["name"] in ("feed.read", "feed.upload",
                                 "fetch.device_wait", "fetch.decode")
            assert x["parent"] == sup[x["se"]]["id"], x

    def walls(name):
        return [round((x["t1_ns"] - x["t0_ns"]) * 1e-9, 6) for x in spans
                if x["name"] == name]

    def stage(name):
        return [r["wall_s"] for r in health if r["stage"] == name]

    for span_name, stage_name in (("dispatch", "track"), (wait, "readback"),
                                  ("supervise", "assess"), ("nav.poll",
                                                            "pvt")):
        np.testing.assert_allclose(walls(span_name), stage(stage_name),
                                   atol=2e-6, err_msg=span_name)
    polls = {x["id"]: x for x in spans if x["name"] == "nav.poll"}
    assert len(polls) == 8
    for name in ("nav.decode", "nav.almanac", "nav.solve"):
        kids = [x for x in spans if x["name"] == name]
        assert len(kids) == 8 and all(x["parent"] in polls for x in kids)
    decode = [x["counters"] for x in spans if x["name"] == "nav.decode"]
    assert all(set(c) == {"tries", "ephemerides"} for c in decode)
    disp = [x["counters"] for x in spans if x["name"] == "dispatch"]
    assert [c["k"] for c in disp] == [4, 4]
    assert all(c["n_active"] >= 1 for c in disp)
    up = [x["counters"]["bytes"] for x in spans
          if x["name"] == "feed.upload"]
    assert up and all(b > 0 for b in up)


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("wire", ["sm2", None])
def test_feed_upload_counts_decoded(samples, wire, prefetch):
    """Every feed.upload span counts the samples the wire table decoded
    for its chunk: the bytes read times the samples a byte for sm2 bytes
    from host memory, 0 for f32 samples. Both loops keep the staging
    counters on it, and on the CPU nothing crosses the pinned ring:
    staged and stage_waits read 0."""
    _, tlm = _run(samples, True, prefetch, wire)
    up = [x["counters"] for x in tlm.spans if x["name"] == "feed.upload"]
    assert up and all(c["bytes"] > 0 for c in up)
    spb = 0 if wire is None else unpack.samples_per_byte(wire)
    assert [c["decoded"] for c in up] == [c["bytes"] * spb for c in up]
    assert [(c["staged"], c["stage_waits"]) for c in up] == \
        [(0, 0)] * len(up)


def test_spans_are_profiler_ranges(samples, tmp_path):
    """Under torch.profiler, every nesting span of a run is one
    gnss.<name> range, on the profiler's clock, as long as its record to
    10% or 50 us in the median, and each to 10% or 10 ms (the host's
    scheduler may take the thread between a span's stamp and its
    range's). The loop is the non-pipelined one: all its spans nest on
    one thread, so no other thread takes the interpreter there (the
    pipelined loop's threads show in test_track_profile_writes_spans)."""
    holder = {}

    class Run:
        device = torch.device("cpu")

        def run(self, n_ms):
            holder["recs"], holder["tlm"] = _run(samples, True, False)
            return []

    _run_profiled(Run(), 800, str(tmp_path))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = {}
    for e in events:
        if e.get("name", "").startswith("gnss.") and e.get("ph") == "X":
            ranges.setdefault(e["name"][5:], []).append(e)
    spans = {}
    for s in holder["tlm"].spans:
        if s["name"] != "superepoch":
            spans.setdefault(s["name"], []).append(s)
    assert sorted(ranges) == sorted(spans)
    excess = []
    for name, recs in spans.items():
        got = sorted(ranges[name], key=lambda e: e["ts"])
        recs = sorted(recs, key=lambda s: s["t0_ns"])
        assert len(got) == len(recs), name
        for e, s in zip(got, recs):
            d_us = (s["t1_ns"] - s["t0_ns"]) * 1e-3
            off = abs(e["dur"] - d_us)
            assert off <= max(0.1 * d_us, 1e4), (name, e["dur"], d_us)
            excess.append(off - max(0.1 * d_us, 50.0))
    assert np.median(excess) <= 0, sorted(excess)[-5:]


def test_track_profile_writes_spans(samples, tmp_path, capsys):
    """`track FILE --profile DIR`: the Chrome trace holds the program's
    phases of all three threads, and DIR/spans.jsonl their records."""
    path = tmp_path / "gps.i8"
    np.clip(np.round(samples * 20.0), -127, 127).astype(np.int8).tofile(
        path)
    out = tmp_path / "prof"
    assert main(["track", str(path), "--device", "cpu", "--fs", "2.048e6",
                 "--if-freq", "0", "--ms", "800", "--channels", "3",
                 "--epoch-ms", "100", "--band", "6e3", "--threshold", "2.4",
                 "--fine-doppler", "10", "--sync-every", "4", "--prefetch",
                 "--log", str(tmp_path / "tlm.jsonl"),
                 "--profile", str(out)]) == 0
    names = {e.get("name") for e in json.loads(
        (out / "trace.json").read_text())["traceEvents"]}
    for phase in ("dispatch", "harvest.wait", "supervise", "feed.read",
                  "fetch.device_wait"):
        assert f"gnss.{phase}" in names, phase
    spans = [json.loads(line)
             for line in (out / "spans.jsonl").read_text().splitlines()]
    assert {s["name"] for s in spans} >= {"superepoch", "dispatch",
                                          "feed.upload", "manager.build"}
    assert all(set(s) == {"name", "id", "parent", "se", "thread", "t0_ns",
                          "t1_ns", "counters"} for s in spans)


L3SIG = SignalConfig(signal="glonass_l3oc", if_freq=0.0, fs=12.0e6,
                     code_freq=glonass_l3.CODE_FREQ,
                     code_length=glonass_l3.CODE_LENGTH, complex_iq=True)


def _l3_samples(n_ms: int) -> np.ndarray:
    """One L3OC satellite (PRN 14): pilot code x NH(10) and, in
    quadrature, data code x Barker(5) (all-ones symbols), 50 dB-Hz."""
    truth = dict(doppler_hz=1320.0, code_phase_chips=2345.5, cn0_dbhz=50.0)
    sats = [SatParams(prn=glonass_l3.pilot_prn(14), carrier_phase=0.0,
                      nav_bits=np.resize(glonass_l3.NH10.astype(np.float32),
                                         n_ms), **truth),
            SatParams(prn=glonass_l3.data_prn(14), carrier_phase=np.pi / 2,
                      nav_bits=np.resize(
                          glonass_l3.BARKER5.astype(np.float32), n_ms),
                      **truth)]
    return IFSimulator(L3SIG, sats, noise_sigma=1.0, seed=4,
                       device="cpu").generate(n_ms)


@pytest.mark.parametrize("family", ["gps_l1ca", "glonass_l3oc"])
def test_search_spans_count_codes_and_combined(samples, family):
    """Each search span says how many code rows it correlated (codes) and
    whether each satellite's pilot and data powers were summed
    (combined): the searches of a GPS run (its host search; both
    satellites are found there) correlate GPS's 32 codes and do not
    combine; in an L3OC run the host search correlates its 63 codes (pilot
    rows 1-32, data rows 33-63) and the on-chunk searches for the absent
    PRN 20 its pilot row and its data row (PRN 52), and each combines.
    The superepoch spans carry no kernel counters on the CPU (the plain
    twins launch nothing)."""
    if family == "gps_l1ca":
        _, tlm = _run(samples, True, True)
        want = {"acq.host_search": {"codes": 32, "combined": 0}}
    else:
        cfg = ReceiverConfig(
            signal=L3SIG,
            acq=AcqConfig(doppler_band=3000.0, coherent_ms=1, threshold=2.5,
                          doppler_step=250.0, prn_list=(14, 20)),
            track=TrackConfig(dll_bw=1.0, el_spacing=0.3, pll_bw=25.0,
                              fll_bw=250.0, aid_div=glonass_l3.CARRIER_HZ
                              / glonass_l3.CODE_FREQ),
            nav=NavConfig(), n_channels=2)
        tlm = Telemetry(trace=True)
        mgr = ChannelManager(
            PackedArraySource(_l3_samples(420), fmt="sm2"), cfg,
            device="cpu", telemetry=tlm, epoch_ms=100, reacq_period_ms=200,
            prn_pool=[14, 20], sync_every=2, engine="fused",
            prefetch=True, readback="compact")
        mgr.run(400)
        assert [s.prn for s in mgr.slots][:1] == [14]
        want = {"acq.host_search": {"codes": 63, "combined": 1},
                "acq.chunk_search": {"codes": 2, "combined": 1}}
    spans = tlm.spans
    for name in ("acq.host_search", "acq.chunk_search"):
        got = [s["counters"] for s in spans if s["name"] == name]
        assert all(c == want[name] for c in got), (name, got)
        assert bool(got) == (name in want), (name, got)
    sup = [s["counters"] for s in spans if s["name"] == "superepoch"]
    assert sup and all(c == {} for c in sup)


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_kernel_event_counters():
    """The superepoch span's kernel counters from timed_launches' events:
    per kernel that launched, its launches and their summed device time
    in ns (K1 as k1_*, K2 as k2_*, K3 as k3_*)."""
    ev = [("track_chunk_fused", _Event(0.0), _Event(0.75)),
          ("track_chunk_dual_fused", _Event(1.0), _Event(3.5)),
          ("track_chunk_boc_fused", _Event(3.6), _Event(3.9)),
          ("track_chunk_fused", _Event(4.0), _Event(4.7)),
          ("track_chunk_dual_fused", _Event(5.0), _Event(7.6))]
    assert track_kernel.event_counters(ev) == {
        "k1_launches": 2, "k1_device_ns": 1_450_000,
        "k2_launches": 1, "k2_device_ns": 300_000,
        "k3_launches": 2, "k3_device_ns": 5_100_000}
    assert track_kernel.event_counters(ev[:1]) == {
        "k1_launches": 1, "k1_device_ns": 750_000}
    assert track_kernel.event_counters([]) == {}
