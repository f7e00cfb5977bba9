"""The harness is driven by data: BENCHMARK.json keeps to its schema,
each cell finds its configuration, traffic mix, signal and metric readers
by name, a configuration, a mix, a signal and a metric added only as new
files are listed and planned without an edit to any file already there,
and every path of the benchmark is a regular file or a directory."""

import hashlib
import json
import os
import re
import shutil
import stat
import types

import pytest

from portbench import peaks, plan
from portbench.gen import sky as skymod

BENCH = plan.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_its_schema():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for c in BENCH["configs"]:
        assert (plan.ROOT / c["file"]).is_file() and c["name"] in [
            w["config"] for w in BENCH["workloads"]]
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        reported = [m for m in BENCH["end_to_end"] + BENCH["per_layer"]
                    if w["name"] in m.get("workloads", cells)]
        assert sum(m in BENCH["per_layer"] for m in reported) >= 1
        assert sum(m in BENCH["end_to_end"] for m in reported) >= 2
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_parts(cell):
    c = plan.plan(BENCH, cell)
    assert c.config["name"] == cell.split(".")[0]
    assert c.traffic["feed"] in ("host", "device")
    for m in c.per_layer:
        assert callable(plan.reader(m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(ValueError):
        plan.plan(BENCH, "no_such.cell")


def test_a_config_of_an_unknown_signal_is_refused(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(plan.HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = json.loads((base / "configs" / "gps_l1ca_12ch.json").read_text())
    cfg["signal"]["signal"] = "gps_l5"
    (base / "configs" / "gps_l1ca_12ch.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="signals/gps_l5.py"):
        plan.plan(BENCH, "gps_l1ca_12ch.hostfed_44s", base)
    with pytest.raises(ValueError, match="signals/gps_l5.py"):
        skymod.signal_of(cfg, base)


@pytest.mark.parametrize("path", BENCH["paths"])
def test_every_path_is_a_regular_file_or_a_directory(path):
    """No symbolic link, no file with a second hard link (as one into the
    program's tree would have) and no git submodule under the
    benchmark's paths: a checkout holds what is written there."""
    top = plan.ROOT / path
    assert stat.S_ISDIR(os.lstat(top).st_mode), top
    odd = []
    for folder, dirs, files in os.walk(top):
        for name in dirs + files:
            p = os.path.join(folder, name)
            st = os.lstat(p)
            if name == ".git" or not (
                    stat.S_ISDIR(st.st_mode)
                    or (stat.S_ISREG(st.st_mode) and st.st_nlink == 1)):
                odd.append(p)
    assert not odd, odd


def _digests(folder):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file()}


def test_a_cell_added_as_files_only(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(plan.HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = _digests(base)
    cfg = json.loads((base / "configs" / "gps_l1ca_12ch.json").read_text())
    cfg.update(name="gps_l1ca_24ch", kernel="K2")
    cfg["manager"]["n_channels"] = 24
    (base / "configs" / "gps_l1ca_24ch.json").write_text(json.dumps(cfg))
    # A kernel the benchmark has not met: its counter, symbol and work
    # as a new data file, its roofline as a new reader.
    (base / "kernels" / "K2.json").write_text(json.dumps(
        {"name": "K2", "counter": "track_chunk_boc_fused",
         "symbol": "track_boc_fused_kernel", "flops_per_sample": 22.0,
         "tap_planes": 3, "state_lanes": 16, "out_lanes": 16}))
    (base / "metrics" / "k2.roofline_pct.py").write_text(
        (base / "metrics" / "k1.roofline_pct.py").read_text()
        .replace("K1", "K2"))
    mix = json.loads((base / "traffic" / "hostfed_44s.json").read_text())
    mix["sky"]["cn0_dbhz"] = 40.0
    (base / "traffic" / "weak_44s.json").write_text(json.dumps(mix))
    # A signal the benchmark has not met: one module under signals/ (the
    # Galileo E1B one under a new name), with a configuration and a mix
    # that name it.
    (base / "signals" / "galileo_e1x.py").write_text(
        (base / "signals" / "galileo_e1b.py").read_text())
    gal = json.loads((plan.HERE / "tests" / "data" / "configs"
                      / "galileo_e1b_12ch.json").read_text())
    gal["signal"]["signal"] = "galileo_e1x"
    gal["name"] = "galileo_e1x_12ch"
    (base / "configs" / "galileo_e1x_12ch.json").write_text(json.dumps(gal))
    (base / "traffic" / "galileo_20s.json").write_bytes(
        (plan.HERE / "tests" / "data" / "traffic" / "galileo_20s.json")
        .read_bytes())
    (base / "metrics" / "manager.readback_pct.py").write_text(
        "def read(ctx):\n"
        "    s = ctx['stage_s']\n"
        "    return 100.0 * s['readback'] / ctx['window_s'] "
        "if 'readback' in s else None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="gps_l1ca_24ch",
                                 file="portbench/configs/gps_l1ca_24ch.json"))
    bench["workloads"].append({"name": "gps_l1ca_24ch.weak_44s",
                               "config": "gps_l1ca_24ch",
                               "traffic": "weak_44s", "chips": 1,
                               "why": "new"})
    bench["workloads"].append({"name": "galileo_e1x_12ch.galileo_20s",
                               "config": "galileo_e1x_12ch",
                               "traffic": "galileo_20s", "chips": 1,
                               "why": "new signal"})
    bench["per_layer"].append({"name": "manager.readback_pct", "unit": "%",
                               "better": "lower", "source": "program_span",
                               "layer": "supervision",
                               "moves": "device_ms_per_signal_s",
                               "workloads": ["gps_l1ca_24ch.weak_44s"]})
    bench["per_layer"].append({"name": "k2.roofline_pct", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "tracking kernels",
                               "moves": "device_ms_per_signal_s",
                               "workloads": ["gps_l1ca_24ch.weak_44s"]})
    assert "gps_l1ca_24ch" in plan.listed("configs", ".json", base)
    assert "weak_44s" in plan.listed("traffic", ".json", base)
    assert "manager.readback_pct" in plan.listed("metrics", ".py", base)
    c = plan.plan(bench, "gps_l1ca_24ch.weak_44s", base)
    assert c.config["manager"]["n_channels"] == 24
    assert c.traffic["sky"]["cn0_dbhz"] == 40.0
    assert [m["name"] for m in c.per_layer] == ["manager.readback_pct",
                                                 "k2.roofline_pct"]
    read = plan.reader("manager.readback_pct", base / "metrics")
    assert read({"stage_s": {"readback": 2.0}, "window_s": 8.0}) == 25.0
    assert read({"stage_s": {}, "window_s": 8.0}) is None
    assert c.kernel["counter"] == "track_chunk_boc_fused"
    n_bytes, flops = peaks.launch_work(c.kernel, c.config)
    assert n_bytes > 0 and flops == 22.0 * 24 * 500 * 2048
    trace = types.SimpleNamespace(kernel=lambda sym: (
        (10, 10 * 1e-3) if sym == "track_boc_fused_kernel" else None))
    share = plan.reader("k2.roofline_pct", base / "metrics")(
        {"trace": trace, "config": c.config,
         "kernels": {c.kernel["name"]: c.kernel}})
    assert share == pytest.approx(
        100.0 * peaks.bound_s(n_bytes, flops) / 1e-3)
    assert "galileo_e1x" in plan.listed("signals", ".py", base)
    g = plan.plan(bench, "galileo_e1x_12ch.galileo_20s", base)
    sky = skymod.make_sky(g.config, g.traffic, 2 ** 31 + 3, base)
    assert sky.signal.module.__file__ == str(base / "signals"
                                             / "galileo_e1x.py")
    assert len(sky.prns) == 8 and len(sky.absent) == 2 and sky.ephs
    assert sky.signal.code(sky.prns[0]).shape == (8184,)
    after = _digests(base)
    assert all(after[p] == d for p, d in before.items())


class _Event:
    def __init__(self, name, kind, t0, t1):
        self._n, self._k, self._t0, self._t1 = name, kind, t0, t1

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def device_type(self):
        return "DeviceType.CUDA"

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._t1 - self._t0


def test_device_time_is_the_union_of_device_work():
    """trace.busy_s: kernels, copies and sets that overlap count once;
    annotation ranges are not work."""
    from portbench import trace

    events = [_Event("K1", "kernel", 0, 400), _Event("copy", "gpu_memcpy",
                                                      300, 500),
              _Event("set", "gpu_memset", 1000, 1100),
              _Event("window", "gpu_user_annotation", 0, 5000)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    assert trace.busy_s(prof) == pytest.approx(600e-9)
    prof.profiler.kineto_results.events = lambda: []
    assert trace.busy_s(prof) == 0.0


@pytest.mark.parametrize("name", ["live.realtime_factor",
                                  "live.superepoch_ms_p95"])
def test_pace_readers_read_the_window(name):
    read = plan.reader(name)
    w = {"superepochs": 900, "realtime_factor": 75.0,
         "superepoch_ms_p95": 90.0}
    assert read({"window": w}) == w[name.split(".", 1)[1]]
    assert read({"window": dict(w, superepochs=0)}) is None
