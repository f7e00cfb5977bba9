"""Command line of the port: `python -m gnsstpu_torch track FILE ...`.

Mirrors `python -m gnsstpu track` (gnsstpu/cli.py) for IF files: acquire +
track with the live ChannelManager on a CUDA device (or --device cpu),
optionally with the online navigator (--navigate), a JSONL telemetry
log (--log), and a checkpoint of the live channel bank saved after the
run (--checkpoint) or restored before it (--resume, a warm restart with
no reacquisition). The options of the reference that depend on parts not
ported yet (--listen, --mesh, --profile, --stream, --station-port, a
--source-fs resampler) raise NotImplementedError naming the ROADMAP
item.
"""

from __future__ import annotations

import argparse
import os
import sys


def _sig_config(args):
    from gnsstpu_torch.config import SignalConfig
    from gnsstpu_torch.signals.registry import get_signal

    sd = get_signal(args.signal)
    return SignalConfig(signal=args.signal, fs=args.fs,
                        if_freq=args.if_freq, code_freq=sd.code_freq,
                        code_length=sd.code_length)


def _refuse_unported(args) -> None:
    todo = {"listen": "the remaining CLI commands",
            "mesh": "parallel/", "profile": "the remaining CLI commands",
            "stream": "the remaining CLI commands",
            "station_port": "the remaining CLI commands"}
    for opt, item in todo.items():
        if getattr(args, opt) is not None:
            raise NotImplementedError(
                f"--{opt.replace('_', '-')} is not ported yet: ROADMAP "
                f"queue 1, '{item}'")
    if args.source_fs and args.source_fs != args.fs:
        raise NotImplementedError(
            "--source-fs resampling is not ported yet: ROADMAP queue 1, "
            "'resample'")


def cmd_track(args) -> int:
    from gnsstpu_torch.config import AcqConfig, ReceiverConfig, TrackConfig
    from gnsstpu_torch.runtime.telemetry import Telemetry
    from gnsstpu_torch.runtime.manager import ChannelManager
    from gnsstpu_torch.runtime.sources import FileSource

    _refuse_unported(args)
    sig = _sig_config(args)
    acq = AcqConfig(doppler_band=args.band, coherent_ms=args.coherent,
                    noncoherent=args.noncoherent, threshold=args.threshold,
                    fine_doppler_ms=args.fine_doppler)
    cfg = ReceiverConfig(signal=sig, acq=acq,
                         track=TrackConfig(dll_bw=args.dll_bw),
                         n_channels=args.channels)
    src = FileSource(args.file, fmt=args.format,
                     skip_samples=args.skip_samples)
    bus = None
    if args.commands:
        from gnsstpu_torch.runtime.console import CommandBus
        bus = CommandBus(args.commands)
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
    sink = open(args.log, "w") if args.log else sys.stdout
    try:
        mgr = ChannelManager(src, cfg, device=args.device,
                             telemetry=Telemetry(sink=sink),
                             epoch_ms=args.epoch_ms, commands=bus,
                             engine=args.engine, navigator=navr,
                             sync_every=args.sync_every,
                             prefetch=args.prefetch,
                             readback=args.readback,
                             history_window_ms=args.history_window_ms)
        if args.resume:
            mgr.restore_checkpoint(args.resume)
        recs = mgr.run(args.ms)
        if args.checkpoint:
            mgr.save_checkpoint(args.checkpoint)
        if navr is not None and args.assist and navr.almanac:
            navr.save_assist(args.assist)
    finally:
        if args.log:
            sink.close()
    live = [int(p) for p in (recs[-1].prn if recs else []) if p]
    print(f"tracked {args.ms} ms; live PRNs at end: {live}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gnsstpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("track", help="acquire + track an IF file with the "
                                     "manager")
    p.add_argument("file", help="IF sample file")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the card; default) or cpu")
    p.add_argument("--signal", default="gps_l1ca")
    p.add_argument("--fs", type=float, default=16.0e6)
    p.add_argument("--if-freq", type=float, default=2.42e6)
    p.add_argument("--format", default="i8_iq",
                   choices=["i8_iq", "i8", "i16_iq", "c64"])
    p.add_argument("--skip-samples", type=int, default=0)
    p.add_argument("--source-fs", type=float, default=None)
    p.add_argument("--band", type=float, default=14e3)
    p.add_argument("--coherent", type=int, default=2)
    p.add_argument("--noncoherent", type=int, default=1)
    p.add_argument("--threshold", type=float, default=2.5)
    p.add_argument("--fine-doppler", type=int, default=10)
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
                        "for galileo_e1b)")
    p.add_argument("--sync-every", type=int, default=1)
    p.add_argument("--prefetch", action="store_true")
    p.add_argument("--readback", default="f32",
                   choices=["f32", "compact"])
    p.add_argument("--use-iono", action="store_true")
    p.add_argument("--carrier-smoothing", type=float, default=0.0,
                   metavar="S")
    p.add_argument("--phase-rate", action="store_true")
    p.add_argument("--assist", default=None)
    p.add_argument("--assist-seed", default=None)
    p.add_argument("--history-window-ms", type=int, default=None)
    p.add_argument("--navigate", nargs="?", const="lsq", default=None,
                   choices=["lsq", "ekf"])
    p.add_argument("--commands", default=None)
    for opt in ("--listen", "--mesh", "--profile", "--stream",
                "--station-port"):
        p.add_argument(opt, default=None, help="not ported yet (raises)")
    p.set_defaults(fn=cmd_track)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
