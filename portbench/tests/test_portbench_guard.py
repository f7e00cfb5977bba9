"""The import guard and the harness's refusals: no JAX, jaxlib, flax or
JAX package in a run, nothing of the program in the reference or the
generator, no result without a card or without the program."""

import json
import os
import shutil
import subprocess
import sys

from portbench import guard, plan

REFUSED = ("jax", "jaxlib", "flax", "gnsstpu")


def test_names_are_compared_whole():
    mods = dict.fromkeys(["gnsstpu_torch", "gnsstpu_torch.runtime.manager",
                          "gnsstpu", "gnsstpu.ops", "jax", "jaxlib.xla",
                          "jaxtyping", "flax.core", "numpy", "jax_x"])
    assert guard.loaded(REFUSED, mods) == ["flax.core", "gnsstpu",
                                           "gnsstpu.ops", "jax",
                                           "jaxlib.xla"]
    assert "gnsstpu_torch.runtime.manager" in guard.loaded(
        REFUSED + ("gnsstpu_torch",), mods)


def _python(code: str, cwd) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(cwd))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_reference_and_generator_load_nothing_of_the_program():
    code = ("import portbench.reference.compare, portbench.reference.truth,"
            " portbench.gen.ifsim, portbench.gen.sky, portbench.control;"
            " from portbench import guard; print(guard.loaded(("
            "'jax', 'jaxlib', 'flax', 'gnsstpu', 'gnsstpu_torch')))")
    p = _python(code, plan.ROOT)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_the_program_loads_no_jax():
    code = ("import portbench.system; from portbench import guard;"
            " print(guard.loaded(('jax', 'jaxlib', 'flax', 'gnsstpu')))")
    p = _python(code, plan.ROOT)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_no_result_without_a_card():
    """This host has no card: the run exits non-zero and prints nothing
    on standard output (it never falls back to the CPU)."""
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "gps_l1ca_12ch.hostfed_44s", "--seed", "2147483999",
         "--seconds", "1", "--trace", "0"],
        cwd=plan.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files:
    the run cannot load the program and prints no result."""
    shutil.copy(plan.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(plan.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import argparse, json; from portbench import run;"
            " a = argparse.Namespace(workload='gps_l1ca_12ch.hostfed_44s',"
            " seed=5, seconds=1.0, trace=0);"
            " print(json.dumps(run.run(a, 'cpu')[0]))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(tmp_path)
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "gnsstpu_torch" in p.stderr
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())["paths"] \
        == ["portbench"]
