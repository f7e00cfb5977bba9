"""Command line of the port: `python -m gnsstpu_torch <command> ...`.

Mirrors `python -m gnsstpu` (gnsstpu/cli.py) on a CUDA device (or
--device cpu):

  simulate  synthesize an i8_iq IF file from PRN:DOPPLER:CODEPHASE specs
  acquire   cold FFT search on an IF file, one JSON line per PRN found
  track     acquire + track with the live ChannelManager, from an IF file
            (optionally streamed through a producer thread and the ring
            FIFO, --stream, and rate-converted, --source-fs) or from a
            radio process over TCP or UDP (--listen, the byte protocol of
            docs/RADIO_FRONTEND.md); optionally with the online navigator
            (--navigate), a JSONL telemetry log (--log), a station server
            that fans the telemetry out and takes commands over TCP
            (--station-port), a torch.profiler trace (--profile) and a
            checkpoint of the channel bank (--checkpoint / --resume),
            sharded over a device mesh (--mesh channel=N: the family's
            kernel once per shard, on the --device given)
  solve     the offline chain to a position fix over an IF file
            (runtime.receiver.run_receiver: acquisition, the chunked
            tracker, nav decode, PVT), optionally its PVT records as a
            telemetry log (--log)
  monitor   the channel status board of a telemetry log or, with
            tcp://HOST:PORT, of a receiver's station server
  analyze   render the analysis panels of a telemetry log (viz; needs
            matplotlib, which only this command imports)

Not ported yet: `bench` (the reference's runs the TPU round's bench.py;
the port's waits for the H100 benchmark, ROADMAP queue 1 item 10). A
live stream's history and FIFO hold two of the manager's chunks (at
least the reference's 1,024 blocks), so no read of a superepoch falls
off the ring.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np


def _sig_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the card; default) or cpu")
    p.add_argument("--signal", default="gps_l1ca")
    p.add_argument("--fs", type=float, default=16.0e6)
    p.add_argument("--if-freq", type=float, default=2.42e6)
    p.add_argument("--format", default="i8_iq",
                   choices=["i8_iq", "i8", "i16_iq", "c64"])
    p.add_argument("--skip-samples", type=int, default=0)
    p.add_argument("--source-fs", type=float, default=None,
                   help="raw file sample rate; when it differs from --fs "
                        "the samples are rate-converted on the fly on the "
                        "device (the reference resamples every front end "
                        "to 2.048 Msps, gps_source.cpp:436)")
    p.add_argument("--resample-mode", default="polyphase",
                   choices=["polyphase", "nearest"])


def _acq_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--band", type=float, default=14e3)
    p.add_argument("--coherent", type=int, default=2)
    p.add_argument("--noncoherent", type=int, default=1)
    p.add_argument("--threshold", type=float, default=2.5)
    p.add_argument("--fine-doppler", type=int, default=10)


def _sig_config(args):
    from gnsstpu_torch.config import SignalConfig
    from gnsstpu_torch.signals.registry import get_signal

    sd = get_signal(args.signal)
    return SignalConfig(signal=args.signal, fs=args.fs,
                        if_freq=args.if_freq, code_freq=sd.code_freq,
                        code_length=sd.code_length)


def _acq_config(args):
    from gnsstpu_torch.config import AcqConfig

    return AcqConfig(doppler_band=args.band, coherent_ms=args.coherent,
                     noncoherent=args.noncoherent,
                     threshold=args.threshold,
                     fine_doppler_ms=args.fine_doppler)


def _file_source(args):
    from gnsstpu_torch.ops.resample import ResampledSource
    from gnsstpu_torch.runtime.sources import FileSource

    src = FileSource(args.file, fmt=args.format,
                     skip_samples=args.skip_samples)
    if args.source_fs and args.source_fs != args.fs:
        src = ResampledSource(src, args.source_fs, args.fs,
                              mode=args.resample_mode, device=args.device)
    return src


def _stream_blocks(sig, args, wire) -> int:
    """Blocks of a live stream's history and FIFO for this run's manager
    (sources.stream_blocks)."""
    from gnsstpu_torch.runtime.manager import ChannelManager
    from gnsstpu_torch.runtime.sources import stream_blocks

    chunk = ChannelManager.chunk_samples(
        sig, args.epoch_ms, sync_every=args.sync_every,
        prefetch=args.prefetch, wire=wire)
    return stream_blocks(chunk, sig.samples_per_code)


def _listen_source(sig, args):
    """(source, producer) of a network front end: a radio process writes
    IF bytes to this port; packed ops.unpack formats ride the FIFO
    untouched and unpack on the device."""
    from gnsstpu_torch import native
    from gnsstpu_torch.ops import unpack as up
    from gnsstpu_torch.runtime.sources import (PackedStreamSource,
                                               SocketStreamProducer,
                                               StreamSource,
                                               TcpStreamProducer)

    proto, _, port = args.listen.partition(":")
    if proto not in ("tcp", "udp"):
        raise SystemExit(f"--listen {args.listen!r}: use tcp:PORT or "
                         "udp:PORT")
    fmt = args.listen_fmt
    raw = fmt in up.WIRE_FORMATS
    blk = sig.samples_per_code
    blocks = _stream_blocks(sig, args, fmt if raw else None)
    blk_bytes = up.wire_bytes(fmt, blk) if raw else blk * 8
    fifo = native.RingFifo(depth=blocks, block_bytes=blk_bytes)
    cls = TcpStreamProducer if proto == "tcp" else SocketStreamProducer
    prod = cls(fifo, blk, fmt=fmt, raw=raw, host="0.0.0.0",
               port=int(port or 0), timeout_s=30.0).start()
    print(f"listening for IF samples on {proto}://0.0.0.0:{prod.port} "
          f"({fmt}{', device unpack' if raw else ''})", file=sys.stderr,
          flush=True)
    if raw:
        src = PackedStreamSource(fifo, blk, fmt=fmt, history_blocks=blocks,
                                 timeout_s=30.0)
    else:
        src = StreamSource(fifo, blk, history_blocks=blocks,
                           timeout_s=30.0)
    return src, prod


def _file_stream_source(sig, args):
    """(source, producer) of --stream: a producer thread reads (and
    resamples) the file into the ring FIFO."""
    from gnsstpu_torch import native
    from gnsstpu_torch.runtime.sources import (FileStreamProducer,
                                               StreamSource)

    blk = sig.samples_per_code
    blocks = _stream_blocks(sig, args, None)
    fifo = native.RingFifo(depth=blocks, block_bytes=blk * 8)
    src_fs = args.source_fs or 0.0
    prod = FileStreamProducer(
        args.file, fifo, blk, fmt=args.format,
        realtime_fs=(sig.fs if args.stream == "realtime" else 0.0),
        skip_samples=args.skip_samples,
        fs_in=src_fs, fs_out=(sig.fs if src_fs else 0.0),
        resample_mode=args.resample_mode, device=args.device).start()
    return StreamSource(fifo, blk, history_blocks=blocks), prod


class _MergedBus:
    """The command file's commands, then the station's."""

    def __init__(self, *buses):
        self.buses = buses

    def poll(self) -> list:
        return [c for b in self.buses for c in b.poll()]


def _run_profiled(mgr, n_ms: int, out_dir: str):
    """mgr.run under torch.profiler (host ops, and the device's kernels
    on a card), written to out_dir/trace.json as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if mgr.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        recs = mgr.run(n_ms)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace: {path}", file=sys.stderr, flush=True)
    return recs


def cmd_track(args) -> int:
    from gnsstpu_torch.config import ReceiverConfig, TrackConfig
    from gnsstpu_torch.runtime.manager import ChannelManager
    from gnsstpu_torch.runtime.telemetry import Telemetry

    sig = _sig_config(args)
    cfg = ReceiverConfig(signal=sig, acq=_acq_config(args),
                         track=TrackConfig(dll_bw=args.dll_bw),
                         n_channels=args.channels)
    prod = srv = None
    if args.listen:
        src, prod = _listen_source(sig, args)
    elif args.file is None:
        raise SystemExit("track: provide an IF FILE or --listen")
    elif args.stream:
        src, prod = _file_stream_source(sig, args)
    else:
        src = _file_source(args)
    sink = open(args.log, "w") if args.log else sys.stdout
    try:
        bus = None
        if args.commands:
            from gnsstpu_torch.runtime.console import CommandBus
            bus = CommandBus(args.commands)
        tlm = Telemetry(sink=sink)
        if args.station_port is not None:
            # Remote station transport: telemetry fans out over TCP and
            # station commands ride the same socket back (`monitor
            # tcp://HOST:PORT --interactive` on another machine).
            from gnsstpu_torch.runtime.remote import StationServer
            srv = StationServer(host="0.0.0.0", port=args.station_port)
            srv.attach(tlm)
            print(f"station server on tcp://0.0.0.0:{srv.port}",
                  file=sys.stderr, flush=True)
            bus = (srv.commands if bus is None
                   else _MergedBus(bus, srv.commands))
        navr = None
        if args.navigate:
            from gnsstpu_torch.config import NavConfig
            from gnsstpu_torch.runtime.navigator import OnlineNavigator
            navcfg = NavConfig(use_iono=args.use_iono,
                               carrier_smoothing_s=args.carrier_smoothing)
            navr = OnlineNavigator(sig, navcfg, mode=args.navigate,
                                   phase_rate=args.phase_rate)
            if args.assist and os.path.exists(args.assist):
                seed_pos = seed_t = None
                if args.assist_seed:
                    vals = [float(v) for v in args.assist_seed.split(",")]
                    seed_pos, seed_t = vals[:3], vals[3]
                navr.load_assist(args.assist, seed_pos=seed_pos,
                                 seed_t=seed_t)
        mesh = None
        if args.mesh:
            # '--mesh channel=4' (or 'channel=2,doppler=2'): the manager
            # splits the slot bank and tracking state over the channel
            # axis, on the cards of --device (or CPU devices).
            from gnsstpu_torch.parallel import make_mesh
            axes = [(kv.split("=")[0], int(kv.split("=")[1]))
                    for kv in args.mesh.split(",")]
            n = math.prod(size for _, size in axes)
            mesh = make_mesh(axes, devices=None if args.device == "cuda"
                             else [args.device] * n)
        mgr = ChannelManager(src, cfg, device=args.device, telemetry=tlm,
                             epoch_ms=args.epoch_ms, commands=bus,
                             engine=args.engine, navigator=navr,
                             sync_every=args.sync_every,
                             prefetch=args.prefetch,
                             readback=args.readback,
                             history_window_ms=args.history_window_ms,
                             mesh=mesh)
        if args.resume:
            mgr.restore_checkpoint(args.resume)
        if args.profile:
            recs = _run_profiled(mgr, args.ms, args.profile)
        else:
            recs = mgr.run(args.ms)
        if args.checkpoint:
            mgr.save_checkpoint(args.checkpoint)
        if navr is not None and args.assist and navr.almanac:
            navr.save_assist(args.assist)
    finally:
        if prod is not None:
            prod.stop()
        if srv is not None:
            srv.close()
        if args.log:
            sink.close()
    live = [int(p) for p in (recs[-1].prn if recs else []) if p]
    print(f"tracked {args.ms} ms; live PRNs at end: {live}")
    return 0


def cmd_acquire(args) -> int:
    from gnsstpu_torch.acquisition.search import (acq_samples_needed,
                                                  acquire, acquire_fdma)
    from gnsstpu_torch.signals.registry import get_signal

    sig = _sig_config(args)
    acq = _acq_config(args)
    src = _file_source(args)
    samples = src.read(0, acq_samples_needed(sig, acq))
    fn = acquire_fdma if get_signal(args.signal).fdma_zero_prn else acquire
    res = fn(samples, sig, acq, device=args.device)
    for i in np.argsort(-res.peak_metric):
        if res.peak_metric[i] < 1.5:
            continue
        print(json.dumps({
            "prn": int(i) + 1, "metric": round(float(res.peak_metric[i]), 2),
            "detected": bool(res.detected[i]),
            "code_phase": int(res.code_phase[i]),
            "carr_freq_hz": round(float(res.carr_freq[i]), 1)}))
    return 0


def cmd_solve(args) -> int:
    from gnsstpu_torch.config import ReceiverConfig
    from gnsstpu_torch.runtime.receiver import run_receiver

    sig = _sig_config(args)
    cfg = ReceiverConfig(signal=sig, acq=_acq_config(args),
                         n_channels=args.channels, ms_to_process=args.ms)
    src = _file_source(args)
    out = run_receiver(src, cfg, n_ms=args.ms, device=args.device)
    print(f"acquired: {out.acq.detected_prns()}")
    print(f"ephemerides decoded: {sorted(out.ephs)}")
    if args.log and out.nav is not None:
        # The solution stream as telemetry (the SPS/PVT message family),
        # so `monitor --page pvt` and `analyze` work on offline solves.
        from gnsstpu_torch.runtime.telemetry import Telemetry

        with open(args.log, "w") as f:
            tlm = Telemetry(sink=f)
            n = out.nav
            for k in range(len(n.t_ms)):
                if not n.valid[k]:
                    continue
                tlm.pvt(int(n.t_ms[k]), float(n.latitude[k]),
                        float(n.longitude[k]), float(n.height[k]),
                        int(n.n_sats[k]),
                        gdop=round(float(n.dop[k, 0]), 2),
                        hdop=round(float(n.dop[k, 2]), 2))
    if out.nav is not None and np.any(out.nav.valid):
        v = out.nav.valid
        print(json.dumps({
            "lat_deg": float(np.mean(out.nav.latitude[v])),
            "lon_deg": float(np.mean(out.nav.longitude[v])),
            "h_m": float(np.mean(out.nav.height[v])),
            "epochs": int(np.sum(v))}))
        return 0
    print("no position fix")
    return 1


def cmd_simulate(args) -> int:
    from gnsstpu_torch.sim import IFSimulator, SatParams

    sig = _sig_config(args)
    rng = np.random.default_rng(args.seed)
    sats = []
    for spec in args.sat:
        prn, dopp, phase, cn0 = (spec.split(":") + ["45"])[:4]
        nav = rng.choice([-1.0, 1.0], 1500).astype(np.float32)
        sats.append(SatParams(prn=int(prn), doppler_hz=float(dopp),
                              code_phase_chips=float(phase),
                              cn0_dbhz=float(cn0), nav_bits=nav))
    sim = IFSimulator(sig, sats, noise_sigma=1.0, seed=args.seed,
                      device=args.device)
    with open(args.out, "wb") as f:
        for ms0 in range(0, args.ms, 256):
            n = min(256, args.ms - ms0)
            blk = sim.generate(n, ms0)
            q = np.clip(np.round(blk * args.scale), -127, 127
                        ).astype(np.int8)
            q.reshape(-1).tofile(f)
    print(f"wrote {args.ms} ms ({args.ms * sim.block_samples} samples) "
          f"to {args.out} (i8_iq)")
    return 0


def cmd_monitor(args) -> int:
    """The channel status board of a telemetry JSONL file or a live
    station link; --interactive runs the curses ground station."""
    import time as _time

    from gnsstpu_torch.runtime.console import StatusBoard
    from gnsstpu_torch.runtime.remote import parse_tcp_url

    if args.interactive:
        from gnsstpu_torch.runtime.station import GroundStation, run_curses

        return run_curses(
            GroundStation(args.log, command_path=args.commands),
            interval=args.interval)

    board = StatusBoard()

    def show():
        return (board.render_all() if args.page == "all"
                else board.render(args.page))

    tcp = parse_tcp_url(args.log)
    if tcp is not None:
        # A remote receiver: follow its live feed (the socket has no
        # history, so a one-shot render needs a log file).
        if not args.follow:
            raise SystemExit(
                "monitor tcp:// is a live feed: add --follow (or "
                "--interactive for the full station)")
        from gnsstpu_torch.runtime.remote import StationSocket
        link = StationSocket(*tcp)
        try:
            while True:
                for line in link.read_lines():
                    try:
                        board.update(json.loads(line))
                    except json.JSONDecodeError:
                        pass
                print("\033[2J\033[H" + show(), flush=True)
                if link.closed:
                    print("-- receiver closed the link", flush=True)
                    return 0
                _time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0
        finally:
            link.close()

    if not args.follow:
        board.feed_jsonl(args.log)
        print(show())
        return 0
    pos = 0
    try:
        while True:
            with open(args.log) as f:
                f.seek(pos)
                for line in f:
                    if line.strip():
                        board.update(json.loads(line))
                pos = f.tell()
            print("\033[2J\033[H" + show(), flush=True)
            _time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def cmd_analyze(args) -> int:
    """Render the offline analysis panels of a telemetry log (the
    reference's matlab/*.m log-analysis scripts)."""
    from gnsstpu_torch import viz

    os.makedirs(args.out, exist_ok=True)
    health_png = os.path.join(args.out, "health.png")
    viz.plot_health(args.log, health_png)
    print(f"wrote {health_png}")
    ekf_png = os.path.join(args.out, "ekf.png")
    if viz.plot_ekf_log(args.log, ekf_png):
        print(f"wrote {ekf_png}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gnsstpu_torch", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("acquire", help="cold acquisition on an IF file")
    p.add_argument("file")
    _sig_args(p)
    _acq_args(p)
    p.set_defaults(fn=cmd_acquire)

    p = sub.add_parser("track", help="acquire + track with the manager")
    p.add_argument("file", nargs="?", default=None,
                   help="IF sample file (omit with --listen)")
    p.add_argument("--listen", default=None, metavar="tcp:PORT|udp:PORT",
                   help="ingest IF samples from a network front end "
                        "instead of a file (byte protocol: "
                        "docs/RADIO_FRONTEND.md); port 0 = OS-assigned, "
                        "printed at start")
    p.add_argument("--listen-fmt", default="i8_iq",
                   choices=["i8_iq", "i16_iq", "c64", "i8", "gn3s_2bit",
                            "iq8", "iq4", "sm2", "iq1"],
                   help="wire format of the listened stream: decoded on "
                        "the host (i8_iq, i16_iq, c64, i8, gn3s_2bit) or "
                        "packed (iq8, iq4, sm2, iq1: shipped packed and "
                        "unpacked on the device, the production live path)")
    _sig_args(p)
    _acq_args(p)
    p.add_argument("--ms", type=int, default=5000)
    p.add_argument("--channels", type=int, default=8)
    p.add_argument("--epoch-ms", type=int, default=100)
    p.add_argument("--dll-bw", type=float, default=1.0)
    p.add_argument("--log", default=None, help="telemetry JSONL path")
    p.add_argument("--checkpoint", default=None,
                   help="save the live channel bank here after the run "
                        "(.npz; warm-restart with --resume)")
    p.add_argument("--resume", default=None,
                   help="warm-restart from a saved channel bank: resume "
                        "tracking with no reacquisition")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "fused", "gather", "table"],
                   help="tracking engine (auto = fused: kernel K1, or K2 "
                        "for galileo_e1b, K3 for glonass_l3oc)")
    p.add_argument("--sync-every", type=int, default=1,
                   help="supervision epochs per device round trip")
    p.add_argument("--prefetch", action="store_true",
                   help="overlap chunk read/upload with device compute "
                        "(reader thread; needs --sync-every > 1)")
    p.add_argument("--readback", default="f32",
                   choices=["f32", "compact"])
    p.add_argument("--use-iono", action="store_true")
    p.add_argument("--carrier-smoothing", type=float, default=0.0,
                   metavar="S")
    p.add_argument("--phase-rate", action="store_true")
    p.add_argument("--assist", default=None)
    p.add_argument("--assist-seed", default=None)
    p.add_argument("--history-window-ms", type=int, default=None)
    p.add_argument("--stream", nargs="?", const="fast", default=None,
                   choices=["fast", "realtime"],
                   help="feed the file via a producer thread and the ring "
                        "FIFO (realtime = throttle to fs)")
    p.add_argument("--navigate", nargs="?", const="lsq", default=None,
                   choices=["lsq", "ekf"])
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace (Chrome JSON) to "
                        "DIR/trace.json")
    p.add_argument("--commands", default=None,
                   help="JSONL command file polled each epoch "
                        "(drop/mask/unmask/set/stop)")
    p.add_argument("--station-port", type=int, default=None,
                   help="serve telemetry + accept station commands on "
                        "this TCP port (monitor remotely with `monitor "
                        "tcp://HOST:PORT --follow`); 0 = OS-assigned")
    p.add_argument("--mesh", default=None, metavar="AXIS=N[,AXIS=N]",
                   help="run the receiver sharded over a device mesh, "
                        "e.g. channel=2: cuda:0..N-1 with --device cuda "
                        "(fewer cards are shared, with a warning), N "
                        "copies of --device otherwise")
    p.set_defaults(fn=cmd_track)

    p = sub.add_parser("solve", help="full chain to a position fix")
    p.add_argument("file")
    _sig_args(p)
    _acq_args(p)
    p.add_argument("--ms", type=int, default=40000)
    p.add_argument("--channels", type=int, default=8)
    p.add_argument("--log", default=None,
                   help="write PVT solutions as telemetry JSONL")
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("simulate", help="write a synthetic IF file")
    p.add_argument("out")
    _sig_args(p)
    p.add_argument("--sat", action="append", required=True,
                   metavar="PRN:DOPPLER:CODEPHASE[:CN0]")
    p.add_argument("--ms", type=int, default=2000)
    p.add_argument("--scale", type=float, default=24.0)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("monitor", help="status board from a telemetry log")
    p.add_argument("log",
                   help="telemetry JSONL path, or tcp://HOST:PORT of a "
                        "receiver started with --station-port")
    p.add_argument("--follow", action="store_true")
    p.add_argument("--interval", type=float, default=1.0)
    p.add_argument("--page", default="channels",
                   choices=["channels", "pvt", "health", "events", "eph",
                            "alm", "all"])
    p.add_argument("--interactive", action="store_true",
                   help="curses ground station (live pages, sparklines, "
                        "command entry)")
    p.add_argument("--commands", default=None,
                   help="command file the live receiver polls "
                        "(interactive ':' commands append here)")
    p.set_defaults(fn=cmd_monitor)

    p = sub.add_parser("analyze",
                       help="render analysis panels from a telemetry log")
    p.add_argument("log")
    p.add_argument("--out", default="analysis")
    p.set_defaults(fn=cmd_analyze)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
