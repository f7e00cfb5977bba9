"""Find a cell's parts by name: BENCHMARK.json at the checkout's root
names cells; each names a configuration (configs/<config>.json), a traffic
mix (traffic/<traffic>.json) and, through the per-layer metrics that list
it, metric readers (metrics/<metric>.py); the configuration names its
signal (signals/<signal>.py: codes, sky and broadcast truth) and its
tracking kernel (kernels/<kernel>.json: launch counter, device symbol and
least work per sample). Adding a cell, or a signal, is adding files
and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def listed(folder: str, suffix: str, base: Path = HERE) -> list:
    """Names of the files in base/<folder> that end in suffix."""
    d = base / folder
    return sorted(p.name[: -len(suffix)] for p in d.glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def _load(path: Path, prefix: str):
    """The Python file at path, loaded as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, folder: Path = HERE / "metrics"):
    """The `read` function of metrics/<name>.py."""
    return _load(folder / f"{name}.py", "portbench_metric_").read


def signal(name: str, base: Path = HERE):
    """The module signals/<name>.py under base: `code(prn)`, one code
    period of +-1 int8 chips at the configuration's code rate;
    `sky(sig, traffic, seed)`, the recording's truth drawn from the seed;
    `broadcast(eph)`, the {field: value} a decoder must read of one
    satellite's ephemeris (None for a signal that carries none). A
    ValueError names the file where there is none."""
    path = base / "signals" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no signal {name!r}: missing {path}")
    return _load(path, "portbench_signal_")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    kernel: dict          # kernels/<config's kernel>.json
    end_to_end: list      # metric entries of BENCHMARK.json
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def plan(bench: dict, cell: str, base: Path = HERE) -> Cell:
    """The cell named `cell` with its configuration, traffic and metrics,
    found under `base` (ValueError for a name BENCHMARK.json does not
    list, or a part without its file)."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if cell not in by_name:
        raise ValueError(f"no workload {cell!r} in BENCHMARK.json "
                         f"(have {sorted(by_name)})")
    w = by_name[cell]
    paths = (base / "configs" / f"{w['config']}.json",
             base / "traffic" / f"{w['traffic']}.json")
    for p in paths:
        if not p.is_file():
            raise ValueError(f"{cell}: missing {p}")
    config = load_json(paths[0])
    sig = config["signal"]["signal"]
    if not (base / "signals" / f"{sig}.py").is_file():
        raise ValueError(f"{cell}: missing {base / 'signals' / sig}.py")
    kpath = base / "kernels" / f"{config['kernel']}.json"
    if not kpath.is_file():
        raise ValueError(f"{cell}: missing {kpath}")
    per_layer = [m for m in bench["per_layer"] if _applies(m, cell)]
    for m in per_layer:
        if not (base / "metrics" / f"{m['name']}.py").is_file():
            raise ValueError(f"{cell}: no reader metrics/{m['name']}.py")
    return Cell(name=cell, chips=int(w["chips"]), config=config,
                traffic=load_json(paths[1]), kernel=load_json(kpath),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, cell)],
                per_layer=per_layer)


def load_bench(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found: run from the checkout")
    return load_json(path)
