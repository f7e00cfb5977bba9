"""The port's live feed against the reference's: the ring FIFO (the
reference's C++ bound by each package), SimSource and the stream
sources, the UDP and TCP producers, a manager fed over TCP, the watchdog
restart, and the one deviation, a read longer than the history.

Socket and thread rules here: ports are bound to 0, every thread is
joined with a timeout, every socket is closed in a `finally`, every
blocking call has a timeout (up to 30 s: far above what the work needs,
so that a loaded host does not trip them), and nothing asserts a
wall-clock speed.
"""

import io
import json
import socket
import threading

import numpy as np
import pytest

from gnsstpu import native as jnative
from gnsstpu.config import (AcqConfig, ReceiverConfig, SignalConfig,
                            TrackConfig)
from gnsstpu.ops import unpack as jup
from gnsstpu.runtime import sources as jsrc
from gnsstpu.sim import IFSimulator, SatParams
from gnsstpu_torch import native as tnative
from gnsstpu_torch.runtime import sources as tsrc
from gnsstpu_torch.runtime.manager import ChannelManager
from gnsstpu_torch.runtime.telemetry import Telemetry
from torch_port import (  # noqa: F401
    one_torch_thread_per_worker, reference_native_library, to_port)

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
JOIN_S = 30.0


def _fifo_script(mod) -> list:
    """One scripted sequence on a depth-3 FIFO of 8-byte blocks: every
    return code, popped block and stats() along the way."""
    f = mod.RingFifo(depth=3, block_bytes=8)
    blk = [np.full(8, i, np.uint8) for i in range(8)]
    log = []

    def pop(ms):
        r, b = f.pop(timeout_ms=ms)
        log.append(("pop", r, b.tolist() if r == 1 else None))

    for i in range(4):                       # to full, then an overrun
        log.append(("push", f.push(blk[i])))
    log.append(("stats", f.stats()))
    log.append(("push_wait", f.push(blk[4], timeout_ms=20)))  # times out
    pop(100)
    log.append(("push_wait", f.push(blk[4], timeout_ms=20)))  # room now
    for _ in range(3):
        pop(100)
    pop(20)                                  # empty: times out
    log.append(("push", f.push(blk[5])))
    log.append(("stats", f.stats()))
    f.close()
    log.append(("push_wait", f.push(blk[6], timeout_ms=20)))  # closed
    log.append(("push", f.push(blk[7])))     # non-blocking ignores close
    for _ in range(3):                       # drain, then -1
        pop(100)
    log.append(("stats", f.stats()))
    return log


def test_ring_fifo_matches_reference():
    assert tnative.available()
    ref = _fifo_script(jnative)
    port = _fifo_script(tnative)
    assert port == ref
    assert [e[1] for e in port if e[0] == "pop"][-1] == -1
    assert port[4] == ("stats", {"count": 3, "pushed": 3, "popped": 0,
                                 "overruns": 1})


def test_sim_source_matches_reference():
    """Both packages' SimSource over their simulators of one noise-free
    2-SV sky (the two draw noise from other generators): reads across
    the 256 ms cache, before sample 0 and past the end."""
    from gnsstpu_torch.sim import IFSimulator as TSim
    from gnsstpu_torch.sim import SatParams as TSat

    sats = [(5, 900.0, 200.5), (12, -1500.0, 700.25)]
    jsim = IFSimulator(SIG, [SatParams(prn=p, doppler_hz=d,
                                       code_phase_chips=c, cn0_dbhz=47.0)
                             for p, d, c in sats], noise_sigma=0.0)
    tsim = TSim(to_port(SIG), [TSat(prn=p, doppler_hz=d,
                                    code_phase_chips=c, cn0_dbhz=47.0)
                               for p, d, c in sats], noise_sigma=0.0,
                device="cpu")
    jsrc_, tsrc_ = jsrc.SimSource(jsim, 300), tsrc.SimSource(tsim, 300)
    assert len(tsrc_) == len(jsrc_) == 300 * 2048
    for start, count in ((-100, 500), (255 * 2048 - 7, 4096),
                         (299 * 2048, 4096), (400 * 2048, 10)):
        np.testing.assert_allclose(tsrc_.read(start, count),
                                   jsrc_.read(start, count), rtol=0,
                                   atol=1e-5)


def _fill(mod, blocks: list) -> object:
    """A FIFO of each package holding `blocks`, closed (end of stream)."""
    f = mod.RingFifo(depth=len(blocks) + 1, block_bytes=blocks[0].nbytes)
    for b in blocks:
        assert f.push(b.view(np.uint8).reshape(-1)) == 1
    f.close()
    return f


def test_stream_source_matches_reference():
    """Both packages' StreamSource over the same 16 blocks with a 4-block
    history: a window, data fallen off the ring, a read across the end
    and past it (end of stream), and stats()."""
    blk = 64
    rng = np.random.default_rng(1)
    blocks = [rng.normal(size=(blk, 2)).astype(np.float32)
              for _ in range(16)]
    reads = [(5 * blk, 2 * blk), (7 * blk + 5, blk), (14 * blk, blk),
             (3 * blk, 2 * blk), (12 * blk + 9, 3 * blk), (16 * blk, blk)]
    out = {}
    for name, mod, smod in (("ref", jnative, jsrc), ("port", tnative, tsrc)):
        src = smod.StreamSource(_fill(mod, blocks), blk, history_blocks=4,
                                timeout_s=5.0)
        out[name] = [src.read(s, n) for s, n in reads] + [src.stats()]
    for a, b in zip(out["ref"][:-1], out["port"][:-1]):
        np.testing.assert_array_equal(b, a)
    assert out["port"][-1] == out["ref"][-1]
    np.testing.assert_array_equal(out["port"][0][:blk], blocks[5])
    assert not np.any(out["port"][3])                 # fell off the ring
    assert not np.any(out["port"][5])                 # end of stream


def test_packed_stream_source_matches_reference():
    """Both packages' PackedStreamSource over the same sm2 blocks: packed
    and decoded reads, zero-fill of data off the ring, ended_at."""
    blk = 64
    rng = np.random.default_rng(2)
    iq = rng.normal(size=(16 * blk, 2)).astype(np.float32)
    wire = jup.pack(iq, "sm2")
    bpb = jup.wire_bytes("sm2", blk)
    blocks = [wire[i * bpb:(i + 1) * bpb] for i in range(16)]
    packed_reads = [(4 * blk, 2 * blk), (10 * blk + 2, blk),
                    (2 * blk, blk), (14 * blk, 4 * blk)]
    reads = [(13 * blk + 3, blk + 7), (15 * blk, 2 * blk)]
    out = {}
    for name, mod, smod in (("ref", jnative, jsrc), ("port", tnative, tsrc)):
        src = smod.PackedStreamSource(_fill(mod, blocks), blk, fmt="sm2",
                                      history_blocks=6, timeout_s=5.0)
        got = [src.read_packed(s, n) for s, n in packed_reads]
        got += [src.read(s, n) for s, n in reads]
        got += [src.ended_at(15 * blk), src.ended_at(16 * blk),
                src.stats()]
        out[name] = got
    for a, b in zip(out["ref"][:6], out["port"][:6]):
        np.testing.assert_array_equal(b, a)
    assert out["port"][6:] == out["ref"][6:]
    assert out["port"][6:8] == [False, True]
    assert not np.any(out["port"][2])                 # fell off the ring


def _send(proto: str, port: int, data: bytes, step: int = 1472) -> None:
    """Send `data` in `step`-byte pieces (misaligned to the blocks) and
    end the stream: a zero-length datagram (UDP) or a close (TCP)."""
    if proto == "udp":
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            for i in range(0, len(data), step):
                tx.sendto(data[i: i + step], ("127.0.0.1", port))
            tx.sendto(b"", ("127.0.0.1", port))
        finally:
            tx.close()
        return
    tx = socket.create_connection(("127.0.0.1", port), timeout=5.0)
    try:
        for i in range(0, len(data), step):
            tx.sendall(data[i: i + step])
    finally:
        tx.close()


def _drain(fifo) -> list:
    out = []
    while True:
        r, b = fifo.pop(timeout_ms=2000)
        if r != 1:
            assert r == -1, "producer never closed the FIFO"
            return out
        out.append(b.tobytes())


@pytest.mark.parametrize("proto", ["udp", "tcp"])
@pytest.mark.parametrize("fmt", ["i8_iq", "sm2"])
def test_net_producers_match_reference(proto, fmt):
    """UDP and TCP producers of both packages fed the same bytes in
    1,472-byte pieces push the same blocks: decoded f32 (i8_iq) or the
    packed bytes untouched (sm2, raw). 24 KB in all: it fits the loopback
    socket's receive buffer, so no datagram is dropped."""
    blk, n_blk = 256, 40
    raw = fmt == "sm2"
    rng = np.random.default_rng(3)
    n_bytes = (jup.wire_bytes(fmt, blk) if raw else 2 * blk) * n_blk
    data = rng.integers(0, 256, n_bytes + 100, dtype=np.uint8).tobytes()
    got = {}
    for name, mod, smod in (("ref", jnative, jsrc), ("port", tnative, tsrc)):
        blk_bytes = jup.wire_bytes(fmt, blk) if raw else blk * 8
        fifo = mod.RingFifo(depth=n_blk + 4, block_bytes=blk_bytes)
        cls = (smod.SocketStreamProducer if proto == "udp"
               else smod.TcpStreamProducer)
        prod = cls(fifo, blk, fmt=fmt, raw=raw, timeout_s=30.0)
        try:
            prod.start()
            _send(proto, prod.port, data)
            prod.thread.join(timeout=JOIN_S)
            assert not prod.thread.is_alive()
        finally:
            prod.stop()
            prod.thread.join(timeout=JOIN_S)
        got[name] = (_drain(fifo), fifo.stats(), prod.overruns)
    assert len(got["port"][0]) == n_blk
    assert got["port"] == got["ref"]


def _gps_sky(prns_dopp, n_ms: int, seed: int) -> np.ndarray:
    sats = [SatParams(prn=p, doppler_hz=d, code_phase_chips=cp,
                      cn0_dbhz=47.0) for p, d, cp in prns_dopp]
    return np.asarray(IFSimulator(SIG, sats, noise_sigma=1.0,
                                  seed=seed).generate(n_ms))


def test_manager_over_tcp_equals_packed_array():
    """Stream transparency: the port's manager (CPU, K1's twin) fed sm2
    bytes through TCP -> RingFifo -> PackedStreamSource gives the records
    that the same bytes give through PackedArraySource."""
    samples = _gps_sky([(6, -1100.0, 512.5)], 940, seed=12)
    wire = jup.pack(samples, "sm2", scale=1.0)
    blk = SIG.samples_per_code
    cfg = to_port(ReceiverConfig(
        signal=SIG,
        acq=AcqConfig(doppler_band=6e3, coherent_ms=2, threshold=2.4,
                      prn_list=(6, 9), fine_doppler_ms=10),
        track=TrackConfig(dll_bw=1.0), n_channels=2))
    kw = dict(device="cpu", epoch_ms=100, reacq_period_ms=400,
              cn0_drop_dbhz=35.0, prn_pool=[6, 9], sync_every=4,
              prefetch=True, readback="compact", history_window_ms=36_000)
    n_blk = len(samples) // blk
    fifo = tnative.RingFifo(depth=n_blk + 8,
                            block_bytes=jup.wire_bytes("sm2", blk))
    prod = tsrc.TcpStreamProducer(fifo, blk, fmt="sm2", raw=True,
                                  timeout_s=30.0).start()
    sender = threading.Thread(target=_send,
                              args=("tcp", prod.port, wire.tobytes(),
                                    65536), daemon=True)
    try:
        sender.start()
        src = tsrc.PackedStreamSource(fifo, blk, fmt="sm2",
                                      history_blocks=n_blk, timeout_s=30.0)
        assert ChannelManager.chunk_samples(
            cfg.signal, 100, sync_every=4, prefetch=True, wire="sm2") \
            < n_blk * blk
        live = ChannelManager(src, cfg, telemetry=Telemetry(
            sink=io.StringIO()), **kw)
        assert live.wire == "sm2"
        recs = live.run(800)
        sender.join(timeout=JOIN_S)
        assert not sender.is_alive()
    finally:
        prod.stop()
        prod.thread.join(timeout=JOIN_S)
    assert prod.overruns == 0 and src.stats()["overruns"] == 0
    arr = ChannelManager(tsrc.PackedArraySource(samples, fmt="sm2"), cfg,
                         telemetry=Telemetry(sink=io.StringIO()), **kw)
    recs_arr = arr.run(800)
    assert len(recs) == len(recs_arr) == 8
    for a, b in zip(recs_arr, recs):
        assert a.epoch_ms == b.epoch_ms
        for f in ("prn", "cn0_dbhz", "pll_lock", "doppler_hz"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    assert int(recs[-1].prn[0]) == 6
    assert abs(recs[-1].doppler_hz[0] + 1100.0) < 5.0


def test_watchdog_restart_recovers_tracking():
    """tests/test_stream.py's watchdog case on the port: a producer that
    stalls at 700 ms is restarted through the source's restart hook; the
    manager emits one watchdog_restart, drops both channels, acquires
    them again and ends the run tracking. The reference's manager, fed
    the same blocks, gives the same events. The producer here pushes its
    blocks before the run and, on the restart, the rest of the stream,
    into a FIFO deep enough for either: the one stall is where the data
    ends, never a producer thread the scheduler left behind."""
    n_ms, stall_at = 1500, 700
    samples = _gps_sky([(5, 900.0, 200.5), (12, -1500.0, 700.25)],
                       n_ms + 50, seed=3)
    blk = SIG.samples_per_code
    results = {}
    for name, mod, smod in (("ref", jnative, jsrc), ("port", tnative, tsrc)):
        fifo = mod.RingFifo(depth=1024, block_bytes=blk * 8)

        def produce(ms0, ms1, fifo=fifo):
            for m in range(ms0, ms1):
                b = samples[m * blk:(m + 1) * blk]
                assert fifo.push(b.view(np.uint8).reshape(-1)) == 1
            if ms1 >= n_ms + 50:
                fifo.close()

        produce(0, stall_at)

        def factory(produce=produce):
            produce(stall_at, n_ms + 50)

        src = smod.StreamSource(fifo, blk, timeout_s=1.0).set_restart(
            factory)
        cfg = ReceiverConfig(
            signal=SIG,
            acq=AcqConfig(doppler_band=6e3, coherent_ms=2, threshold=2.4,
                          prn_list=(5, 12), fine_doppler_ms=10),
            track=TrackConfig(dll_bw=1.0), n_channels=3)
        sink = io.StringIO()
        kw = dict(epoch_ms=100, reacq_period_ms=300, cn0_drop_dbhz=35.0,
                  prn_pool=[5, 12], sync_every=2)
        if name == "ref":
            from gnsstpu.runtime.manager import ChannelManager as JManager
            from gnsstpu.runtime.telemetry import Telemetry as JTelemetry
            mgr = JManager(src, cfg, telemetry=JTelemetry(sink=sink), **kw)
        else:
            mgr = ChannelManager(src, to_port(cfg), device="cpu",
                                 telemetry=Telemetry(sink=sink), **kw)
        try:
            recs = mgr.run(n_ms)
        finally:
            fifo.close()
        evs = [json.loads(line) for line in sink.getvalue().splitlines()]
        restarts = [e for e in evs if e.get("what") == "watchdog_restart"]
        drops = sorted(e["prn"] for e in evs
                       if e.get("what") == "channel_drop"
                       and e.get("why") == "watchdog_restart")
        t_restart = restarts[0]["epoch_ms"] if restarts else None
        re_starts = sorted(e["prn"] for e in evs
                           if e.get("what") == "channel_start"
                           and t_restart is not None
                           and e["epoch_ms"] > t_restart)
        results[name] = (len(restarts), src.restarts, t_restart, drops,
                         re_starts, sorted(int(p) for p in recs[-1].prn
                                           if p))
    assert results["port"] == results["ref"]
    assert results["port"][:2] == (1, 1)
    assert results["port"][3:] == ([5, 12], [5, 12], [5, 12])


@pytest.mark.parametrize("epoch_ms,sync_every,prefetch,wire", [
    (100, 1, False, None), (500, 8, True, "sm2"), (400, 3, False, "iq1")])
def test_chunk_samples_is_the_managers_chunk(epoch_ms, sync_every,
                                             prefetch, wire):
    """ChannelManager.chunk_samples, which sizes a stream's history, is
    the chunk the constructed manager reads, GPS and Galileo E1B."""
    from gnsstpu_torch.config import ReceiverConfig as TConfig
    from gnsstpu_torch.config import SignalConfig as TSignal
    from gnsstpu_torch.signals import galileo_e1

    x = np.zeros((8192, 2), np.float32)
    for sig in (TSignal(if_freq=0.0, fs=2.048e6, complex_iq=True),
                TSignal(signal="galileo_e1b", if_freq=0.0, fs=4.2e6,
                        code_freq=galileo_e1.SUB_FREQ,
                        code_length=galileo_e1.SUB_LENGTH)):
        src = (tsrc.PackedArraySource(x, fmt=wire) if wire
               else tsrc.ArraySource(x))
        mgr = ChannelManager(src, TConfig(signal=sig, n_channels=1),
                             device="cpu", epoch_ms=epoch_ms,
                             sync_every=sync_every, prefetch=prefetch)
        assert mgr._chunk_len == ChannelManager.chunk_samples(
            sig, epoch_ms, sync_every=sync_every, prefetch=prefetch,
            wire=wire)
        n = mgr._chunk_len
        assert tsrc.stream_blocks(n, sig.samples_per_code) == max(
            1024, 2 * -(-n // sig.samples_per_code))


def test_read_longer_than_history():
    """The port's one deviation: history 8 blocks, one read of 16. The
    reference serves the read's first half from ring slots that later
    blocks overwrote, as zeros, without an error; the port raises."""
    blk = 64
    rng = np.random.default_rng(5)
    iq = rng.normal(size=(16 * blk, 2)).astype(np.float32)
    wire = jup.pack(iq, "sm2")
    bpb = jup.wire_bytes("sm2", blk)
    blocks = [wire[i * bpb:(i + 1) * bpb] for i in range(16)]
    ref = jsrc.PackedStreamSource(_fill(jnative, blocks), blk, fmt="sm2",
                                  history_blocks=8, timeout_s=5.0)
    got = ref.read_packed(0, 16 * blk)
    assert not np.any(got[: 8 * bpb])
    np.testing.assert_array_equal(got[8 * bpb:], wire[8 * bpb:])
    port = tsrc.PackedStreamSource(_fill(tnative, blocks), blk, fmt="sm2",
                                   history_blocks=8, timeout_s=5.0)
    with pytest.raises(ValueError, match="history"):
        port.read_packed(0, 16 * blk)
    with pytest.raises(ValueError, match="history"):
        port.read(0, 16 * blk)
    np.testing.assert_array_equal(port.read_packed(8 * blk, 8 * blk),
                                  wire[8 * bpb:])
    f32 = [b.astype(np.float32) for b in np.split(iq, 16)]
    src = tsrc.StreamSource(_fill(tnative, f32), blk, history_blocks=8,
                            timeout_s=5.0)
    with pytest.raises(ValueError, match="history"):
        src.read(0, 8 * blk + 1)
    np.testing.assert_array_equal(src.read(4 * blk, 8 * blk),
                                  iq[4 * blk: 12 * blk])
