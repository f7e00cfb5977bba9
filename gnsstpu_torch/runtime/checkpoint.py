"""Checkpoint/resume: persist acquisition results and tracking state.

The reference saves acquisition + tracking results so a rerun can skip
straight to navigation (GPS/L1/postProcessing.sce:81,138 autosave of
trackingResults.dat; skipAcquisition flag initSettings.sci:77); the GUI
dumps/loads almanac/ephemeris state (gse gui_almanac/gui_eeprom). Here any
tracking-state pytree (TrackState and friends are NamedTuple trees of
arrays), acquisition results, and decoded ephemerides round-trip through
one .npz file; resuming a scan from a restored state is bit-exact because
the engines are deterministic functions of (state, samples).

Copied from gnsstpu/runtime/checkpoint.py; only the import prefix differs.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray],
             spec: list) -> None:
    if hasattr(tree, "_fields"):          # NamedTuple node
        spec.append(("nt", type(tree).__module__ + ":" +
                     type(tree).__name__, list(tree._fields)))
        for name in tree._fields:
            _flatten(getattr(tree, name), f"{prefix}.{name}", out, spec)
    elif isinstance(tree, (tuple, list)):
        spec.append(("seq", type(tree).__name__, len(tree)))
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}.{i}", out, spec)
    else:
        spec.append(("leaf", prefix, None))
        out[prefix] = np.asarray(tree)


def _unflatten(spec: list, arrays: Dict[str, np.ndarray], pos: list):
    kind, a, b = spec[pos[0]]
    pos[0] += 1
    if kind == "nt":
        mod, name = a.split(":")
        import importlib

        cls = getattr(importlib.import_module(mod), name)
        return cls(*[_unflatten(spec, arrays, pos) for _ in b])
    if kind == "seq":
        vals = [_unflatten(spec, arrays, pos) for _ in range(b)]
        return tuple(vals) if a == "tuple" else vals
    return arrays[a]


def save(path: str, *, state: Any = None, meta: Optional[dict] = None,
         ephs: Optional[dict] = None, **named_arrays) -> None:
    """Write a checkpoint.

    state: any pytree of arrays built from NamedTuples/tuples/lists.
    meta: JSON-serializable dict (slot assignments, cursor, config echo).
    ephs: {prn: Ephemeris-like dataclass} decoded ephemerides.
    named_arrays: extra arrays (e.g. acquisition metrics).
    """
    arrays: Dict[str, np.ndarray] = {}
    spec: list = []
    if state is not None:
        _flatten(state, "state", arrays, spec)
    payload_meta = {
        "meta": meta or {},
        "spec": spec,
        "ephs": {str(p): {"__cls__": type(e).__module__ + ":" +
                          type(e).__name__, **dataclasses.asdict(e)}
                 for p, e in (ephs or {}).items()},
    }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(payload_meta).encode(), dtype=np.uint8)
    for k, v in named_arrays.items():
        arrays[f"extra.{k}"] = np.asarray(v)
    np.savez(path, **arrays)


def load(path: str) -> Tuple[Any, dict, dict, Dict[str, np.ndarray]]:
    """Read a checkpoint -> (state, meta, ephs, extra arrays)."""
    import importlib

    z = np.load(path, allow_pickle=False)
    payload = json.loads(bytes(z["__meta__"]).decode())
    spec = [tuple(s) for s in payload["spec"]]
    state = None
    if spec:
        state = _unflatten(spec, {k: z[k] for k in z.files}, [0])
    ephs = {}
    for p, d in payload["ephs"].items():
        mod, name = d.pop("__cls__").split(":")
        cls = getattr(importlib.import_module(mod), name)
        ephs[int(p)] = cls(**d)
    extra = {k[len("extra."):]: z[k] for k in z.files
             if k.startswith("extra.")}
    return state, payload["meta"], ephs, extra
