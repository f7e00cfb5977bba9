"""Helpers shared by the port's tests (tests/test_torch_*.py)."""

import dataclasses
import importlib
import os

import pytest
import torch


def to_port(obj):
    """The port's counterpart of a gnsstpu dataclass instance (a config,
    an ephemeris): the class of the same name in the same module of
    gnsstpu_torch, built with the same field values, nested dataclasses
    included. Each package is then handed objects of its own classes."""
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        return obj
    mod = type(obj).__module__
    if mod.split(".")[0] != "gnsstpu":
        raise TypeError(f"{type(obj)} is not a gnsstpu class")
    cls = getattr(importlib.import_module("gnsstpu_torch" + mod[7:]),
                  type(obj).__name__)
    return cls(**{f.name: to_port(getattr(obj, f.name))
                  for f in dataclasses.fields(obj) if f.init})


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_per_worker():
    """Under pytest-xdist, torch runs one intra-op thread per worker: the
    workers already fill the host's cores, and a thread pool per worker on
    top of them oversubscribes it (a port test that takes seconds alone
    took minutes in a six-worker run). A single-process run keeps torch's
    default. Test modules import this fixture to turn it on."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
