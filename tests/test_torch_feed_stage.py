"""The sample feed's pinned staging (gnsstpu_torch/runtime/feed_stage.py,
ChannelManager._upload): a host chunk bound for the card crosses through
the process's ring of page-locked slots on the ring's own stream, and the
stream that reads it waits on the card for the upload's event.

Card tests (marker cuda): a staged chunk decodes bit for bit as the
pageable upload did, for sm2 bytes and f32 samples; chunks read by a
consumer held back on the card, or uploaded by a feed stream held back,
are never overwritten by later ones; every feed.upload span of a
host-fed run counts its bytes as staged, a device-resident run stages
nothing, and the pipeline never waits for a slot. On the CPU the manager
stages nothing (tests/test_torch_telemetry_spans.py). This file imports
neither jax nor gnsstpu, so on the card (whose host lacks jax, which
tests/conftest.py imports):
    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_feed_stage.py
"""

import numpy as np
import pytest
import torch

from gnsstpu_torch.config import (AcqConfig, NavConfig, ReceiverConfig,
                                  SignalConfig, TrackConfig)
from gnsstpu_torch.ops import unpack as up
from gnsstpu_torch.runtime import feed_stage
from gnsstpu_torch.runtime.manager import ChannelManager
from gnsstpu_torch.runtime.sources import (ArraySource,
                                           DevicePackedArraySource,
                                           PackedArraySource)
from gnsstpu_torch.runtime.telemetry import Telemetry
from gnsstpu_torch.sim import IFSimulator, SatParams

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
SATS = [SatParams(prn=5, doppler_hz=900.0, code_phase_chips=200.5,
                  cn0_dbhz=47.0),
        SatParams(prn=12, doppler_hz=-1500.0, code_phase_chips=700.25,
                  cn0_dbhz=46.0)]
#: GPU cycles a held-back stream sleeps before each step (~3 ms at the
#: H100's clocks): longer than a chunk's copy and decode.
HOLD_CYCLES = 5_000_000


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (pinned staging and CUDA streams "
                    "have no CPU mode); run on the card with pytest "
                    "--noconftest -m cuda tests/test_torch_feed_stage.py")
    return torch.device("cuda", 0)


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


def _manager(source, dev, tlm=None, prefetch=False):
    return ChannelManager(source, _cfg(), device=dev, telemetry=tlm,
                          epoch_ms=100, reacq_period_ms=400,
                          cn0_drop_dbhz=35.0, prn_pool=[5, 12],
                          sync_every=4, engine="fused", prefetch=prefetch,
                          readback="compact" if prefetch else "f32")


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["sm2", None])
def test_staged_chunk_is_the_pageable_upload(card, samples, wire):
    """A host chunk staged through the ring and decoded on the ring's
    stream equals, bit for bit, the pageable upload's decode (sm2) or
    samples (f32), read on the current stream after _to_device."""
    src = ArraySource(samples) if wire is None \
        else PackedArraySource(samples, fmt=wire)
    mgr = _manager(src, card)
    for base in (0, 4 * mgr._espc):
        buf, ended, _ = mgr._read_superepoch(base, 4)
        assert not ended
        got = mgr._to_device(buf)
        host = torch.from_numpy(np.ascontiguousarray(buf))
        want = host.to(card) if wire is None \
            else up.unpack(host.to(card), wire)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("held", ["consumer", "feed"])
def test_no_chunk_overwritten_by_a_later_one(card, held):
    """Ten distinct chunks through a three-slot ring, each dropped by the
    host as soon as its read is issued. Held back on the card: the
    consumer before each read (the allocator must not hand a chunk's
    memory back to the ring's stream while the consumer still reads it:
    record_stream), or the ring's stream before each copy (the consumer
    must wait on the card for the copy and its decode, and the host must
    not refill a slot whose copy is still in flight: it waits, and
    stage_waits counts it). Every chunk reads back as its own bytes
    decoded."""
    tlm = Telemetry(trace=True)
    mgr = _manager(PackedArraySource(np.zeros((4096, 2), np.float32),
                                     fmt="sm2"), card, tlm)
    ring = feed_stage.ring(card, mgr._stage_bytes)
    rng = np.random.default_rng(7)
    bufs = [rng.integers(0, 256, mgr._stage_bytes, dtype=np.uint8)
            for _ in range(10)]
    torch.cuda.synchronize(card)
    outs = []
    for buf in bufs:
        if held == "feed":
            with torch.cuda.stream(ring.stream):
                torch.cuda._sleep(HOLD_CYCLES)
        with tlm.span("feed.upload", staged=0, stage_waits=0):
            dev, ready = mgr._upload(buf)
        feed_stage.consume(dev, ready)
        if held == "consumer":
            torch.cuda._sleep(HOLD_CYCLES)
        outs.append(dev.clone())
        del dev
    torch.cuda.synchronize(card)
    for buf, got in zip(bufs, outs):
        assert torch.equal(got, up.unpack(torch.from_numpy(buf).to(card),
                                          "sm2"))
    up_spans = [s["counters"] for s in tlm.spans
                if s["name"] == "feed.upload"]
    assert [c["staged"] for c in up_spans] == [mgr._stage_bytes] * 10
    if held == "feed":
        assert sum(c["stage_waits"] for c in up_spans) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("feed", ["host_sm2", "host_f32", "device_sm2"])
def test_staging_counters_on_a_run(card, samples, feed, prefetch):
    """An 800 ms run, serial and pipelined: every feed.upload span of a
    host-fed run staged all its bytes (staged == bytes), one fed from a
    device-resident source staged nothing, and the pipeline at its
    default depth never waited for a ring slot."""
    src = {"host_sm2": lambda: PackedArraySource(samples, fmt="sm2"),
           "host_f32": lambda: ArraySource(samples),
           "device_sm2": lambda: DevicePackedArraySource(
               samples, fmt="sm2", device=card)}[feed]()
    tlm = Telemetry(trace=True)
    mgr = _manager(src, card, tlm, prefetch)
    mgr.run(800)
    torch.cuda.synchronize(card)
    up_spans = [s["counters"] for s in tlm.spans
                if s["name"] == "feed.upload"]
    assert up_spans and any(c["bytes"] for c in up_spans) \
        == (feed != "device_sm2")
    if feed == "device_sm2":
        assert all(c["staged"] == 0 for c in up_spans)
    else:
        assert [c["staged"] for c in up_spans] == \
            [c["bytes"] for c in up_spans]
    assert all(c["stage_waits"] == 0 for c in up_spans)
    assert mgr.clock_ms == 800
