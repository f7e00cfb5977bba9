"""Smoke run of the PyTorch + CUDA port (gnsstpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's five live receiver paths once on the card, through the
entry points a user calls, each with a sky and signal made by the port's
simulator from a fixed seed, then the live front end (phases 19-21: the
GPS path over TCP with the ring FIFO and a remote station, a 16 Msps
stream resampled on the card, and the command line), then the offline
chain (phases 22-28: runtime.receiver.run_receiver, the chunked
trackers, the P-code loop and the CLI's solve, each at the configuration
of the reference test it names), then the device mesh (phases 29-35:
parallel/, the GPS path sharded over channels, sharded K1, the sharded
and the time-block searches, torch.distributed, track --mesh, and the
Galileo and L3OC paths sharded over channels with K2 and K3 per shard),
then the native host library and the GP2021 integer-correlator
co-simulation against K1 (phase 36), then the bench command (phase 37),
the joint GPS + GLONASS fix (phase 38) and the five end-to-end examples
(phase 39):
  * GPS L1 C/A at the benchmark configuration (bench.py::bench_manager):
    2.048 Msps complex, 12 channels over an 11-satellite geometry-true sky
    plus 2 absent PRNs in the pool, 500 ms epochs, 8-epoch superepochs,
    2-bit sm2 wire resident on the card, prefetch pipeline, compact
    readback, 1 s reacquisition, and the online navigator (LNAV decode +
    LSQ PVT), over ~44 s of signal; it runs kernel K1;
  * Galileo E1B: 4.2 Msps complex, 12 channels over an 8-satellite
    geometry-true sky (tests/test_galileo.py's constellation) plus 2
    absent PRNs, C/N0 48 dB-Hz, 500 ms epochs, 4-epoch superepochs, sm2
    wire on the card, prefetch, compact readback, and the navigator
    (I/NAV decode + LSQ PVT), over ~24 s of signal; it runs kernel K2;
  * GLONASS L3OC pilot + data (glonass_l3oc_live_12ch): the reference
    front end (24 Msps complex, IF -2.025 MHz), 12 channels over 8
    satellites, each a pilot and a data component carrying its own 24
    rate-1/2 encoded bits, plus 2 absent satellites in the pool, C/N0
    48 dB-Hz, sm2 wire on the card, 500 ms epochs, 2-epoch superepochs,
    prefetch, compact readback, the navigator armed (L3OC has no live
    navigation: it reports so once), over 9 s of signal; it runs kernel
    K3, and the data bits come back from the data prompts;
  * BeiDou B1I (beidou_b1i_live_12ch, tests/test_live_families.py's live
    BeiDou receiver widened to 12 slots): 4.096 Msps complex, the 7
    satellites of beidou_constellation above 15 degrees plus 2 absent
    PRNs, 48 dB-Hz, 100 ms epochs, 4-epoch superepochs, sm2 wire on the
    card, prefetch, compact readback, 2 s reacquisition and the navigator
    (D1 decode + LSQ PVT), over 40 s of signal (a slot searched again
    at 2 s still meets a whole D1 frame); it runs K1 at blkp
    4,098;
  * GLONASS L1OF (glonass_l1of_live_12ch, tests/test_glonass.py's live
    receiver at its 8.192 Msps front end, 12 slots): 6 satellites on
    their frequency channels plus 2 absent channels, 48 dB-Hz, FDMA
    acquisition (one code row against the 14-channel x Doppler grid) at
    the cold start and on the superepoch chunks every 2 s, 100 ms epochs,
    4-epoch superepochs, sm2 wire on the card, prefetch, compact readback
    and the navigator (string decode + LSQ PVT), over 12 s of signal; it
    runs K1 at blkp 8,194.

Phases (each prints one line; any failure raises and exits non-zero):
  1. device: a CUDA card is required; its name and power limit;
  2. build: the port's four CUDA kernels (K1-K3 and the epoch summary)
     from the sources in this checkout, one nvcc per source, started
     together, and K1's build
     record (threads per CTA, registers, spill, static and dynamic shared
     memory, samples per prefetch buffer, CTAs resident per SM) at the
     blkp of GPS, BeiDou 4.096 Msps, GLONASS 8.192 Msps and GPS
     16.384 Msps; a spill fails the run;
  3. K1 on the card against its plain PyTorch twin at six shapes: GPS
     2.048 Msps at C=12 x 500 (the main path's launch), 9 x 6 and 48 x 6;
     BeiDou B1I 4.096 Msps (blkp 4,098) and GLONASS L1OF 8.192 Msps (blkp
     8,194, FDMA channels), C=3 x 6; GPS 16.384 Msps (blkp 16,386, past
     the double buffer), C=2 x 4. blksize and sample_pos exact, the other
     lanes at tests/test_track_kernel.py's tolerances, two launches on
     the same inputs bit-identical;
  4. K1 time against the twin (CUDA events, C=12 x 1000 and x 500
     blocks), the kernel alone at C=48 x 500, its per-block floor (C=12 x
     500 blocks of 64 samples; blocks x floor is the chain floor), the
     stamped instance's mean ns per block in each phase (tk.FUSED_PHASES:
     the copies' start and the LO angles beside the chain; the wait on
     the copies, products, reduction, loop update and closing barrier on
     it) at C=12 x 500 and on the floor's blocks, and the time of one
     on-chunk acquisition search;
 40. (printed after 4) the epoch summary kernel (ops/summary_kernel.py,
     csrc/epoch_summary.cu) at the GPS main path's shape, K1's strided
     out of one C=12 x 500 launch into 8 slots of a compact readback,
     against its plain version: stream lanes bit-equal, stats within
     SUMMARY_TOL, two fills bit-identical; us per launch and the plain
     version's us per epoch (CUDA events, queued behind a spin) beside
     its bound, and its build record;
 42. (printed after 40) the wire decode (ops/unpack.py unpack: the int32
     index cast and the gather from the format's 256-row table) of one
     superepoch's sm2 bytes in each benchmark cell (4,096,000 for GPS's
     4 s, 12,000,000 for L3OC's 1 s): ms per decode (CUDA events, queued
     behind a spin) beside its bound (a byte read and two f32 pairs
     written at 3.35 TB/s) and beside the reference arithmetic it
     replaced, on the same bytes; the card's decode bit-identical to the
     CPU's and to that arithmetic; iq8, iq4 and iq1 on the L3OC bytes;
  5. the GPS main path (warm-up run, then a measured run) with its
     end-to-end checks and K1's launch count;
  6. K2's build record: its cluster launch at C=12 (N CTAs per channel,
     S samples per CTA, threads per CTA), registers, spill bytes, static
     and dynamic shared memory, and cudaOccupancyMaxActiveClusters;
  7. K2 on the card against its plain twin (C=12 x 125 blocks, the main
     path's launch, C=3 x 6 blocks, and C=48 x 6 blocks, where a cluster
     has 2 CTAs and each thread takes several 16-sample steps) on a
     Galileo signal: blksize and sample_pos exact, the other lanes within
     the tolerances of K2_TOL, and two launches on the same inputs
     bit-identical;
  8. K2 time against the twin (CUDA events, C=12 x 125 and x 250 blocks);
  9. the Galileo main path with its end-to-end checks and K2's launch
     count;
 10. K3's build record, as K2's, and its tap table's size at C=12, int8
     six planes against the TPU layout, from the shapes;
 11. K3 on the card against its plain twin (C=12 x 500 blocks at 24 Msps,
     the main path's launch, C=3 x 6 blocks, and C=48 x 8 blocks, 2 CTAs
     per cluster and several steps per thread) on an L3OC signal: blksize
     and sample_pos exact, the other lanes within K3_TOL, and two launches
     on the same inputs bit-identical;
 12. K3 time against the twin (CUDA events, C=12 x 500 and x 1000), the
     kernel alone at C=48 x 500 (2 CTAs per channel), and its per-block
     floor (C=12 x 500 blocks of 64 samples);
 13. the GLONASS L3OC main path with its end-to-end checks (every sky
     satellite tracked, Doppler and C/N0, overlay sync, the data bits
     bit-exact, K3 launched and K1 / K2 not) and K3's share of the wall;
 41. (printed after 13) the L3OC on-chunk search on phase 13's signal at
     its shape, for every pilot PRN (the whole 63-code bank), the pool
     and the two absent PRNs: code rows, ms per search (CUDA events) and
     device memory beyond what was allocated before it, each; the absent
     PRNs' lanes must be equal in all three and the last search's other
     lanes 0;
 14. K1 alone (no twin) at the BeiDou and GLONASS launch shapes, C=12 x
     100 blocks (100 ms epochs) and x 500, at blkp 4,098 and 8,194, each
     beside its bound;
 15. the BeiDou B1I main path with its end-to-end checks (every sky SV's
     D1 ephemeris, >= 4 fixes with mean 3D error < 30 m, live channels
     >= sky - 1, no absent PRN confirmed, K1 and neither K2 nor K3, no
     JAX, realtime factor >= 1) and K1's share of the wall;
 16. the GLONASS L1OF main path with the same checks (every string
     ephemeris, >= 8 fixes with mean 3D error < 25 m, at least one
     on-chunk FDMA search after the cold start), and the time and device
     memory of one on-chunk FDMA search at its configuration;
 17. the manager's weak tier (tests/test_pipeline.py:270-312: a GLONASS
     noncoherent search longer than one chunk summed on the card across
     chunks; the late SV found with one host-path search, at epoch 0) and
     checkpoint (tests/test_runtime.py:252-325: save, restore into a new
     manager, resume with no channel start, carrier-phase accumulators
     equal to an uninterrupted run's);
 19. gps_l1_tcp_live_12ch: phase 5's configuration and signal fed as a
     radio feeds it: a sender thread writes the 2-bit sm2 bytes to a
     TcpStreamProducer on loopback at 8 x real time, through the port's
     RingFifo (built with g++ from csrc/host/ring_fifo.cpp) into a
     PackedStreamSource (history and FIFO two chunks deep), uploaded
     packed; a StationServer fans the telemetry out to a StationSocket
     client, which masks an absent PRN after 3 fixes. Phase 5's limits
     (live channels at the last epoch inside the signal), 0 overruns,
     blocks pushed = blocks sent, the run ended by the producer's end of
     stream, the client's channel and PVT records and its command's
     command_ok with the PRN out of the pool, K1 only, no JAX; the
     stage walls, the FIFO's peak fill and K1's share of the wall;
 20. gps_l1_16msps_resampled_12ch: the same sky at the custom front end's
     16 Msps complex (IF 0), 8 s written as i8_iq to a temporary file, a
     FileStreamProducer resampling each 1 ms block to 2.048 Msps on the
     card (polyphase, K = 250, its own CUDA stream) into a StreamSource,
     the manager at 12 channels (K1, 100 ms epochs x 4): live >= 10 of
     11, every live channel's Doppler within 5 Hz of truth, no absent PRN
     confirmed; the apply's ms per 1 ms and 100 ms block (CUDA events),
     its transient memory and its error against a float64 direct sum
     (RESAMPLE_TOL of the input's peak); the nearest mode exact; K1 per
     launch alone and beside a running producer (CUDA events, and its
     kernel time from a profiler trace, within 20%);
 21. the CLI on the card: `python -m gnsstpu_torch track --listen tcp:0
     --listen-fmt sm2 --station-port 0 --profile DIR --log LOG` on a
     3-SV sky sent to its banner's port, `python -m gnsstpu_torch
     monitor tcp://127.0.0.1:PORT --follow` beside it: the banner, the
     sky's PRNs live at the end, a board and exit 0 when the receiver
     closes the link, and a torch.profiler trace naming K1's __global__
     function;
 22. gps_l1_solve_8ch: tests/test_full_chain.py:32-69 (GPS L1 C/A, 2.048
     Msps complex, its 6-SV sky at 47 dB-Hz, 8 channels, 24 s) through
     run_receiver: K1 at C=6 x 256 blocks (tracking.driver.track), then
     LNAV decode and the LSQ; its limits (:72-147): every sky SV
     tracked, every ephemeris as the truth, TOW exact, >= 10 valid
     epochs, mean 3D error < 20 m and max < 60 m, GDOP < 25, mean speed
     < 2 m/s and max < 8;
 23. galileo_e1b_solve_5ch: tests/test_galileo.py:199-242 (4.2 Msps, 5
     channels, 3,250 periods of 4 ms, 48 dB-Hz) through run_receiver and
     track_boc (K2 at C=5 x 128, first held against its twin and bound
     at that shape): every ephemeris as the truth, >= 8 epochs, mean < 25
     m, max < 80 m;
 24. beidou_b1i_solve_6ch: tests/test_beidou.py:176-220 (4.096 Msps, 6
     channels, 20,600 ms, 48 dB-Hz; K1 at blkp 4,098 with the 'atan'
     FLL): every D1 ephemeris as the truth, >= 10 epochs, mean < 25 m,
     max < 80 m;
 25. glonass_l1of_solve_6ch: examples/e2e_glonass_fix.py (4.096 Msps, 6
     channels, 10 s, FDMA acquisition; K1 at blkp 4,098, each channel's
     FDMA carrier base): mean 3D error < 25 m;
 26. glonass_l3oc_track_dual_8ch: track_dual over phase 13's sky (8
     satellites, 24 Msps, 9 s), its channels from the port's acquisition
     (K3 at C=8 x 256, first held against its twin and bound at that
     shape): phase 13's limits (Doppler within 5 Hz, NH(10)
     sync >= 0.9, the 24 data bits exact);
 27. the GLONASS P-code closed loop of tests/test_glonass.py:319-366 on
     the card (tracking.pcode, plain torch ops: the reference has no
     Pallas kernel for it) with that test's limits;
 28. the CLI: phase 22's signal as an i8_iq file, `python -m
     gnsstpu_torch solve FILE --fs 2.048e6 --if-freq 0 --format i8_iq
     --ms 24000 --channels 8 --log LOG` in a subprocess: exit 0, a fix
     within 1e-3 deg of the truth, PVT records in the log;
 29. gps_l1_live_12ch_mesh2: phase 5's configuration and signal through
     ChannelManager(mesh=make_mesh([("channel", 2)])) (one card: both
     shards on it, each launching K1 on its own stream, with make_mesh's
     warning): records and the prompt streams (i_p, q_p, carr_doppler,
     abs_sample, carr_cycles) bit-identical to phase 5's run, phase 5's
     fix limits, K1 launched twice phase 5's count (once per shard per
     epoch), the state split over the mesh's devices; its realtime
     factor and stage walls beside phase 5's;
 30. sharded K1 alone: C=48 x 500 split 4 ways over
     make_sharded_fused_tracker, each shard on its own stream, outputs
     and state bit-identical to one C=48 x 500 launch; ms per sharded
     step and per single launch (CUDA events), the four launches alone
     on their streams and on one stream, and the time the host takes to
     enqueue a step;
 31. the cold search (32 PRNs x the 29 Doppler bins of a 7 kHz band
     padded to 32 x 2,048 lags, two 2 ms windows) on a channel=2 x
     doppler=2 mesh: code_phase and doppler_bin equal to the unsharded
     cube's, the metric within rtol 1e-5; ms (CUDA events) and peak
     device memory of each;
 32. time-block long coherent acquisition (parallel.timeblock): GPS
     2.048 Msps, K = 20 code periods over time=4, 32 PRNs x 41 Doppler
     bins 25 Hz apart, a 34 dB-Hz satellite that a 1 ms search misses:
     the peak at its PRN and bin within 2 samples of its code phase,
     against reference_coherent_power on its row and two others within
     normalised atol 2e-3, time=1 (the tail-only halo) the same; ms and
     peak device memory of each;
 33. phase 32's search in a torch.distributed world (NCCL over a
     localhost TCP store): two processes on two cards at time=2, else
     one at time=1 (this script again, with --timeblock-worker); the
     halo all-gather and the all_reduce run through NCCL in a world of
     one too; the peak in phase 32's cell, the cube against
     reference_coherent_power within normalised atol 2e-3;
 34. the CLI: `python -m gnsstpu_torch track FILE ... --mesh channel=2`
     on phase 28's file against the same command without --mesh, each
     in a subprocess: both exit 0 and their telemetry records (all but
     the wall-clock stamps and stage timings) equal;
 35. galileo_e1b_live_12ch_mesh2 and glonass_l3oc_live_12ch_mesh2:
     phases 9's and 13's configurations and signals through
     ChannelManager(mesh=make_mesh([("channel", 2)])): K2 and K3 launched
     once per shard per epoch (twice the unsharded count), records and
     prompt streams (with L3OC's data prompts) bit-identical to the
     unsharded runs;
 36. gps_l1_gp2021_cosim_12ch: the port's native library (csrc/host/,
     built with g++ on the card's host; the phase fails without it), its
     codecs and packers bit-identical to their NumPy twins on 2^22 seeded
     samples, sm2 packing of 1 s at 2.048 and 16 Msps (host ms, native
     against NumPy, median of 5), and the golden model's uint32 carrier
     phase against ops/nco.freq_to_step_u32; then the GP2021
     co-simulation (native/cosim.py: the reference test's firmware DLL +
     PLL on the integer correlator) against the port's ChannelManager
     with K1 on the card, at the reference cross-check's configuration
     (tests/test_gp2021_cosim.py:114-149: PRN 4, one slot) and at 12
     channels (12 PRNs over +-3 kHz in one IF, one integer channel per
     PRN started at its code start, the float slots with the fine-Doppler
     handoff): per PRN the reference's limits (both envelope stds < 0.2
     and within 0.1 of each other, both Doppler means within 3 Hz, the
     integer loop's pull-in limits) and K1 launched; the 12-channel sky
     again with the reference's coarse handoff, reported and not gated;
 37. bench: `python -m gnsstpu_torch bench` run in this process
     (gnsstpu_torch/__main__.py -> gnsstpu_torch/bench.py), its JSON
     line printed: K1's realtime factor, ms per launch and residency at
     12 / 48 / 192 / 768 channels, the 32 PRN x 29 bin x 2,048-lag cold
     search, and the live GPS receiver host-fed and with the signal on
     the card; each rate > 1, the grid, both receivers within phase 5's
     limits (navigator armed, >= 8 ephemerides, >= 10 fixes, last fix <
     100 m, the 11 sky SVs live, engine fused), K1 launched and K2 / K3
     not, no JAX;
 38. gps_glonass_joint_fix_6ch: tests/test_joint_pvt.py:44-124 on the
     card: GPS L1 C/A (visible_ephs(6)[:3], seed 21) and GLONASS L1OF
     (make_glonass_constellation(n=3), seed 31), 4.096 Msps, 24 s and 3
     channels each, with the reference's noise through run_receiver (K1
     at blkp 4,098 for both): each alone 3 ephemerides and no fix; one
     SystemObs per system into navigate_joint over 10 epochs: >= 8 valid,
     mean 3D error < 30 m and max < 100 m, inter-system bias std < 15 m,
     6 satellites in every valid epoch;
 39. examples: the five end-to-end examples (examples/torch_e2e_gps_l1,
     _position_fix, _glonass_fix, _joint_fix and _multichip.py, the
     ports of examples/e2e_*.py), each in a fresh python3 process on the
     card behind an import system that refuses jax, jaxlib and gnsstpu
     (EXAMPLE_BOOT, which reads main()'s dict and K1's launch counter),
     each with a timeout of its own; per example a line: PASS, wall,
     signal s / wall s, its decode outcome or fix error, and K1's
     launches, held to its reference script's PASS limits (GPS: PRN 7
     alone, ephemeris bit-exact, TOW 266,400 s; position fix: mean 3D
     error < 20 m; GLONASS L1OF: < 25 m; joint: neither system alone
     fixes, >= 8 of 10 epochs valid, < 30 m, bias std < 15 m; multichip:
     a live PRN, the state Sharded on the mesh), K1 launched and K2 / K3
     not, no jax or gnsstpu module loaded;
 18. (printed after 39) K1's launches on each of its paths (the
     examples' in their own processes, read back; the CLI's subprocesses
     uncounted; bench's in this one), K2's and K3's by path, the summary
     kernel's and the wire table's card decodes by path;
Phases 22-25 track the very signal of the reference test they name: the
port's simulator with the reference's noise (IFSimulator(noise="jax"),
jax.random's draws made without JAX) behind the reference test's
SimSource, each read recorded on the card by a first run and served
again to the timed one. Each offline phase prints its seconds of signal,
wall and realtime factor (signal / wall of the timed run), the
split into acquisition, track (uploads, launches, one readback per chunk)
and decode + navigation, its kernel's launches and ms per launch at its
shape (CUDA events, the kernel alone), its outcomes and the jax /
gnsstpu modules loaded (none).
Then the kernel record (each kernel's launches summed over its paths),
the nvidia-smi line and the result line.

Each kernel's bound is the larger of its bytes over 3.35 TB/s (the chunk,
the tap rows this run's data selects, state and outputs, each once) and
its f32 operations over 67 TFLOP/s (per sample and channel: 6 for the LO
products, 6 for the wipeoff and, every tap being +-1, one signed add per
accumulator, K2's sub x code tap products being sign flips: 18 for K1's
six accumulators, 22 for K2's ten, 24 for K3's twelve; the per-block
sincos and loop filters are left out, under 1%), for the samples this
run's blocks cover. The tap rows of all three are int8, one byte per tap.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

from gnsstpu_torch import (AcqConfig, NavConfig, ReceiverConfig,
                           SignalConfig, TrackConfig)
from gnsstpu_torch.acquisition import search
from gnsstpu_torch.bench import (GPS_CHANNELS, GPS_EPOCH_MS, GPS_SECONDS,
                                 GPS_SYNC, _timed_s, gps_config,
                                 gps_manager, gps_sky, gps_windows)
from gnsstpu_torch.bench import GPS_SIG as SIG
from gnsstpu_torch.bench import GPS_TRK as TRK
from gnsstpu_torch.device import u32_numpy, u32_tensor
from gnsstpu_torch.nav import glonass_l3 as l3nav
from gnsstpu_torch.nav.viterbi import conv_encode, viterbi_decode
from gnsstpu_torch import native
from gnsstpu_torch.native import cosim
from gnsstpu_torch.ops import fft_acquire, nco, wire
from gnsstpu_torch.ops import resample as rs
from gnsstpu_torch.ops import summary_kernel as sk
from gnsstpu_torch.ops import track_kernel as tk
from gnsstpu_torch.ops import unpack as up
from gnsstpu_torch.ops.resample import ResampledSource
from gnsstpu_torch.parallel import (make_distributed_mesh, make_mesh,
                                    make_sharded_fused_tracker,
                                    shard_acquisition_inputs,
                                    shard_fused_inputs)
from gnsstpu_torch.parallel.mesh import Sharded, tree_leaves
from gnsstpu_torch.parallel.timeblock import (long_coherent_acquire,
                                              reference_coherent_power)
from gnsstpu_torch.runtime import OnlineNavigator, Telemetry
from gnsstpu_torch.runtime.manager import ChannelManager
from gnsstpu_torch.runtime.remote import StationServer, StationSocket
from gnsstpu_torch.runtime.sources import (ArraySource,
                                           DeviceArraySource,
                                           DevicePackedArraySource,
                                           FileSource, FileStreamProducer,
                                           PackedStreamSource, SimSource,
                                           StreamSource, TcpStreamProducer,
                                           stream_blocks)
from gnsstpu_torch.sim import IFSimulator, SatParams
from gnsstpu_torch.signals import galileo_e1, glonass_l3
from gnsstpu_torch.signals.registry import get_signal
from gnsstpu_torch.sim.scenario import (beidou_constellation,
                                        build_scenario_glonass,
                                        galileo_constellation,
                                        make_glonass_constellation,
                                        position_error_m)
from gnsstpu_torch.tracking import boc as tboc
from gnsstpu_torch.tracking import dual as tdual
from gnsstpu_torch.tracking import fused as tfused
from gnsstpu_torch.tracking import scan as tscan
from gnsstpu_torch.tracking.engines import EpochObs

K1_SOURCE = "gnsstpu_torch/csrc/track_fused.cu"
K1_REPLACES = "gnsstpu/ops/track_kernel.py:274"
# K1's other families and rates (blkp = samples per code + 2): BeiDou B1I
# live at 4.096 Msps (tests/test_live_families.py:206, blkp 4,098),
# GLONASS L1OF at 8.192 Msps (tests/test_glonass.py:19, blkp 8,194) and GPS
# at 16.384 Msps (blkp 16,386, past what K1's double buffer holds).
BSIG = SignalConfig(signal="beidou_b1i", if_freq=0.0, fs=4.096e6,
                    code_freq=2.046e6, code_length=2046, complex_iq=True)
# BeiDou's loop takes the flip-invariant FLL (its NH(20) code flips the
# symbol every block); K1's parity at blkp 4,098 runs it.
BTRK = TrackConfig(dll_bw=1.5, pll_bw=25.0, fll_bw=150.0, fll_disc="atan",
                   aid_div=1561.098e6 / 2.046e6)
OSIG = SignalConfig(signal="glonass_l1of", if_freq=0.0, fs=8.192e6,
                    code_freq=0.511e6, code_length=511, fdma_step=562.5e3,
                    complex_iq=True)
OTRK = TrackConfig(dll_bw=1.0, pll_bw=25.0, fll_bw=250.0,
                   aid_div=1602e6 / 0.511e6)
HSIG = SignalConfig(if_freq=0.0, fs=16.384e6, complex_iq=True)
GSIG = SignalConfig(signal="galileo_e1b", if_freq=0.0, fs=4.2e6,
                    code_freq=galileo_e1.SUB_FREQ,
                    code_length=galileo_e1.SUB_LENGTH)
GTRK = TrackConfig(dll_bw=1.0, el_spacing=0.25, pll_bw=15.0, fll_bw=50.0,
                   sll_bw=0.5, sll_spacing=0.25, aid_div=1540.0)
K2_SOURCE = "gnsstpu_torch/csrc/track_boc_fused.cu"
K2_REPLACES = "gnsstpu/ops/track_kernel.py:938"
#: K2 against its twin: accumulators at K1's tolerances with the absolute
#: part scaled to the 8x longer block (rtol 2e-3, atol 16); Doppler [Hz]
#: and the code / meandr remainders [chips, half-chips] as K1's.
K2_TOL = {"acc_rtol": 2e-3, "acc_atol": 16.0, "carr_doppler": 0.05,
          "rem_code_phase": 5e-4, "rem_sub_phase": 5e-4}
# The reference L3 front end (GLONASS/L3/initSettings.sci:69-75).
LSIG = SignalConfig(signal="glonass_l3oc", if_freq=-2.025e6, fs=24.0e6,
                    code_freq=glonass_l3.CODE_FREQ,
                    code_length=glonass_l3.CODE_LENGTH, complex_iq=True)
LTRK = TrackConfig(dll_bw=1.0, el_spacing=0.3, pll_bw=25.0, fll_bw=250.0,
                   aid_div=glonass_l3.CARRIER_HZ / glonass_l3.CODE_FREQ)
K3_SOURCE = "gnsstpu_torch/csrc/track_dual_fused.cu"
K3_REPLACES = "gnsstpu/ops/track_kernel.py:608"
#: K3 against its twin: accumulators at K1's tolerances with the absolute
#: part scaled to the 12x longer block (rtol 2e-3, atol 24); Doppler [Hz]
#: and the code remainder [chips] as K1's.
K3_TOL = {"acc_rtol": 2e-3, "acc_atol": 24.0, "carr_doppler": 0.05,
          "rem_code_phase": 5e-4}
#: Data bits per L3OC satellite: one rate-1/2 codeword of 2 * (24 + 6)
#: symbols, 300 ms under the Barker(5) overlay, repeated.
L3_BITS = 24
#: The L3OC main path's sky and its absent pool PRNs (the cell's layout).
L3_SKY = [3, 7, 11, 14, 18, 22, 26, 30]
L3_ABSENT = [5, 9]
#: Start of a slot's prompt history left out of the L3 checks: the
#: 2-quadrant FLL pulls a handoff error of up to half a 250 Hz bin in
#: within ~1 s (the reference test's 50 Hz handoff settles in 200 ms).
L3_SETTLE_MS = 1000
SUMMARY_SOURCE = "gnsstpu_torch/csrc/epoch_summary.cu"
#: No Pallas kernel: the reference's summary is XLA ops under jit.
SUMMARY_REPLACES = "gnsstpu/runtime/manager.py:877 (XLA ops)"
#: The summary kernel against its plain version: stats lanes only (the
#: stream lanes are bit-equal); C/N0 in dB, PLL and code lock absolute.
SUMMARY_TOL = {"cn0_dbhz": 1e-3, "pll_lock": 1e-5, "code_lock": 1e-5}
#: H100 SXM peaks: HBM bytes/s, f32 FLOP/s.
HBM_BPS, F32_FLOPS = 3.35e12, 67e12


def ptxas(built) -> str:
    """The ptxas register / spill lines of a kernel build."""
    lines = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln]
    return " / ".join(lines) if lines else "ptxas: no report (cached build)"


def spill_bytes(built):
    """Spill stores + loads ptxas reported for a build (None if no
    report)."""
    found = re.findall(r"(\d+) bytes spill (?:stores|loads)", built.log)
    return sum(map(int, found)) if found else None


def cluster_line(kernel: str, C: int, blkp: int, built, device) -> dict:
    """A cluster kernel's launch at C channels and what it uses; raises
    unless each channel gets N > 1 CTAs at C <= 12."""
    info = tk.cluster_info(kernel, C, blkp, device)
    info["spill_bytes"] = spill_bytes(built)
    info["all_clusters_resident"] = info["max_active_clusters"] >= C
    if C <= 12 and info["N"] <= 1:
        raise AssertionError(f"{kernel}: one CTA per channel at C={C}")
    return info


def repeat_identical(tag: str, inputs, kernel) -> None:
    """Two launches of a kernel on the same inputs give bit-identical
    outputs (its reduction has no atomics); raises otherwise."""
    args, kw = inputs
    first, second = kernel(*args, **kw), kernel(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: two launches differ")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bound(n_bytes: float, flops: float) -> tuple:
    """(bound ms, 'bytes' or 'operations'): the least time the card could
    take for this work on the published peaks."""
    t_b, t_f = n_bytes / HBM_BPS, flops / F32_FLOPS
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def reset_counts() -> None:
    """Zero K1-K3's and the summary kernel's launch counts and the wire
    table's card decodes, at the start of a path."""
    tk.reset_launches()
    up.reset_decodes()


def rows_used(rem0, rem_out, offs, ph, n_rows) -> np.ndarray:
    """[C, n_blocks, len(offs)] table rows the blocks select: each
    block's rows come from the remainder before it (rem0 [C], then the
    previous block's rem_out [n_blocks, C])."""
    rem = np.concatenate([rem0[None], rem_out[:-1]]).astype(np.float32)
    rows = [np.clip(np.rint((rem + np.float32(o)) * np.float32(ph)), 0,
                    n_rows - 1) for o in offs]
    return np.stack(rows, axis=-1).transpose(1, 0, 2).astype(np.int64)


def k1_track_inputs(C: int, n_blocks: int, device, sig=SIG, trk=TRK):
    """The fused tracker's (chunk, tap rows, consts, state) for
    test_track_kernel.py's _setup widened to C channels, with the signal
    from the port's simulator: up to 12 satellites (GLONASS: frequency
    channels, each at its FDMA offset), channel i tracking satellite i
    mod 12."""
    sd = get_signal(sig.signal)
    zero = sd.fdma_zero_prn
    n = min(C, 12)
    prns = ([3, 9, 17, 25, 5, 12, 22, 28, 31, 7, 1, 14] if zero is None
            else [2, 5, 8, 11, 13, 1, 4, 7, 10, 12, 14, 3])[:n]
    offs = [0.0 if zero is None
            else sd.carrier_freq(p) - sd.carrier_freq(zero) for p in prns]
    sats = [SatParams(prn=p, doppler_hz=400.0 * i - 600.0,
                      if_offset_hz=offs[i],
                      code_phase_chips=(50.0 * i + 11.0) % sig.code_length,
                      cn0_dbhz=49.0)
            for i, p in enumerate(prns)]
    chunk = IFSimulator(sig, sats, noise_sigma=1.0, seed=4,
                        device=device).generate_tensor(n_blocks + 3)
    ch = np.arange(C) % n
    tab = torch.as_tensor(tfused.fused_tap_rows(
        tfused.fused_code_table(sig, trk, prns)), device=device)[
            torch.as_tensor(ch, device=device)]
    cb, ia = tscan.channel_consts(
        sig, trk, [prns[i] for i in ch],
        if_offsets_hz=None if zero is None else [offs[i] for i in ch])
    spchip = sig.fs / sig.code_freq
    state0 = tscan.TrackState.init(
        np.array([int(round(sats[i].code_phase_chips * spchip)) for i in ch]),
        np.array([sats[i].doppler_hz + 37.0 for i in ch], np.float32),
        aid_div=trk.aid_div, device=device)
    consts = (u32_tensor(cb, device), torch.as_tensor(ia, device=device))
    return chunk, tab, consts, state0


def k1_inputs(C: int, n_blocks: int, device, sig=SIG, trk=TRK):
    """K1's tensor and static arguments on k1_track_inputs."""
    args = tfused.kernel_inputs(*k1_track_inputs(C, n_blocks, device, sig,
                                                 trk))
    return args, tfused.kernel_kwargs(sig, trk, n_blocks=n_blocks)


def twin_parity(tag: str, inputs, kernel, twin, *, blk_lane: int,
                acc_lanes, acc_tol: tuple, lane_tol: dict,
                max_lsb: int) -> tuple:
    """A kernel's wrapper against its plain twin on the same inputs on the
    card: blksize and sample_pos exact, the carrier phase within max_lsb,
    the accumulators within acc_tol (rtol, atol) and each named lane
    within its atol (lane_tol {name: (lane, atol)}); raises on a breach.
    Returns (largest deviation of each checked quantity, the twin's out
    lanes as numpy)."""
    args, kw = inputs
    k_out, _, k_pos, k_cph = kernel(*args, **kw)
    r_out, _, r_pos, r_cph = twin(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(k_out[..., blk_lane], r_out[..., blk_lane]):
        raise AssertionError(f"{tag}: blksize differs from the twin")
    if not torch.equal(k_pos, r_pos):
        raise AssertionError(f"{tag}: sample_pos differs from the twin")
    dev = {"blksize_sample_pos": "exact"}
    dph = u32_numpy(k_cph).astype(np.int64) - u32_numpy(r_cph).astype(
        np.int64)
    dph = (dph + 2 ** 31) % 2 ** 32 - 2 ** 31
    dev["carr_phase_lsb"] = int(np.max(np.abs(dph)))
    if dev["carr_phase_lsb"] > max_lsb:
        raise AssertionError(f"{tag}: carrier phase beyond {max_lsb} LSB")
    ko, ro = k_out.cpu().numpy(), r_out.cpu().numpy()
    lanes = list(acc_lanes)
    np.testing.assert_allclose(ko[..., lanes], ro[..., lanes],
                               rtol=acc_tol[0], atol=acc_tol[1],
                               err_msg=f"{tag} accumulators")
    dev["acc_abs"] = float(np.max(np.abs(ko[..., lanes] - ro[..., lanes])))
    dev["acc_scale"] = float(np.max(np.abs(ro[..., lanes])))
    for name, (lane, atol) in lane_tol.items():
        np.testing.assert_allclose(ko[..., lane], ro[..., lane], rtol=0,
                                   atol=atol, err_msg=f"{tag} {name}")
        dev[name] = float(np.max(np.abs(ko[..., lane] - ro[..., lane])))
    return dev, ro


def k1_compare(C: int, n_blocks: int, device, sig=SIG, trk=TRK) -> tuple:
    """K1's wrapper against its plain twin on the card at
    test_track_kernel.py's tolerances (carrier phase within one LSB step
    flip per block, counted 4x as there), and against itself on a second
    launch. Returns (deviations, K1's bound at this shape)."""
    args, kw = inputs = k1_inputs(C, n_blocks, device, sig, trk)
    tag = f"K1 {sig.signal} {sig.fs / 1e6:g} Msps C={C}"
    repeat_identical(tag, inputs, tk.track_chunk_fused)
    dev, ro = twin_parity(
        tag, inputs, tk.track_chunk_fused, tk.track_chunk_fused_ref,
        blk_lane=tk.O_BLKSIZE,
        acc_lanes=(tk.O_IE, tk.O_QE, tk.O_IP, tk.O_QP, tk.O_IL, tk.O_QL),
        acc_tol=(2e-3, 2.0),
        lane_tol={"carr_doppler": (tk.O_CARR_DOPPLER, 0.05),
                  "rem_code_phase": (tk.O_REM, 5e-4)},
        max_lsb=4 * n_blocks * kw["blkp"])

    dev["blkp"] = kw["blkp"]
    return dev, k1_bound(inputs, ro)


def k1_bound(inputs, out: np.ndarray) -> tuple:
    """K1's bound for one launch on inputs (args, kw) whose out lanes are
    `out` (numpy): the chunk, the tap rows the blocks select, state and
    outputs once; 18 flops per sample the blocks cover."""
    args, kw = inputs
    chunk, tab, _, finit = args[:4]
    k = tk._consts(**{n: kw[n] for n in ("code_length", "phases_per_chip",
                                         "spacing", "span_chips",
                                         "base_code_step", "fs",
                                         "coefs")})
    rows = rows_used(finit[:, tk._F_REM].cpu().numpy(), out[..., tk.O_REM],
                     k["row_off"], kw["phases_per_chip"], tab.shape[1])
    n_rows = sum(len(np.unique(r)) for r in rows)
    samples = float(out[..., tk.O_BLKSIZE].sum())
    n_bytes = (chunk.numel() * 4 + n_rows * kw["blkp"]
               + 2 * finit.numel() * 4 + out.size * 4)
    return bound(n_bytes, 18.0 * samples)


def k1_alone(C: int, n_blocks: int, device, sig, trk) -> dict:
    """K1 alone (no twin: at blkp 8,194 it takes seconds per call) at one
    launch shape of a live path: ms per launch (CUDA events) and the
    bound from the kernel's own outputs."""
    inputs = k1_inputs(C, n_blocks, device, sig, trk)
    args, kw = inputs
    out = tk.track_chunk_fused(*args, **kw)[0].cpu().numpy()
    ms = kernel_times(inputs, tk.track_chunk_fused, None)[0]
    b_ms, b_by = k1_bound(inputs, out)
    return {"blkp": kw["blkp"], "ms": ms,
            "us_per_block": 1e3 * ms / n_blocks, "bound_ms": b_ms,
            "bound_by": b_by}


def kernel_times(inputs, kernel, twin, reps: int = 20) -> tuple:
    """(kernel ms, plain twin ms) per call on the same inputs (args, kw),
    timed with CUDA events after a warm-up call of each; no twin time
    when twin is None."""
    args, kw = inputs

    def timed(fn, n):
        fn(*args, **kw)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn(*args, **kw)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / n

    return timed(kernel, reps), (timed(twin, 1) if twin else None)


def k1_times(C: int, n_blocks: int, device, twin: bool = True) -> tuple:
    return kernel_times(k1_inputs(C, n_blocks, device),
                        tk.track_chunk_fused,
                        tk.track_chunk_fused_ref if twin else None)


def k1_floor_inputs(C: int, n_blocks: int, device):
    """K1's arguments for blocks of 64 samples (zero signal, one tap row,
    as k3_floor_ms): what a block of its chain costs beyond its samples
    (the copies, the reduction, the loop update, the barriers)."""
    blkp = 64
    i64 = torch.zeros((C,), dtype=torch.int64, device=device)
    args = (torch.zeros((n_blocks * blkp + 256, 2), device=device),
            torch.ones((C, 1, tk.plane_stride(blkp)), dtype=torch.int8,
                       device=device),
            torch.zeros((C,), dtype=torch.int32, device=device),
            torch.zeros((C, tk.NF), device=device), i64, i64.clone())
    kw = dict(tfused.kernel_kwargs(SIG, TRK, n_blocks=n_blocks), blkp=blkp)
    return args, kw


def k1_split(inputs, n_blocks: int) -> dict:
    """K1's stamped instance on inputs (args, kw) of n_blocks blocks: its
    time per launch, the SM clock, and the mean ns per block in each phase
    (tk.FUSED_PHASES), over the channels; cycles_per_block sums the chain
    (tk.FUSED_CHAIN). The clock is torch.cuda.clock_rate() read while
    stamped launches run (NVML; raises where it cannot be read); the
    chain's cycles of a launch over its CUDA-event time are printed beside
    it as a check, not used."""
    args, kw = inputs
    run = tk.track_chunk_fused_stamped
    ms, _ = kernel_times(inputs, run, None, reps=10)
    for _ in range(40):
        stamps = run(*args, **kw)[-1]
    mhz = float(torch.cuda.clock_rate(args[0].device))
    torch.cuda.synchronize()
    cyc = stamps.cpu().numpy().mean(0) / n_blocks
    chain = [tk.FUSED_PHASES.index(n) for n in tk.FUSED_CHAIN]
    per_block = float(cyc[chain].sum())
    return {"ms": ms, "sm_mhz": mhz,
            "sm_mhz_cycles_over_event_time":
                per_block * n_blocks / (ms * 1e3),
            "cycles_per_block": per_block,
            "ns_per_block": {n: 1e3 * float(c) / mhz
                             for n, c in zip(tk.FUSED_PHASES, cyc)}}


def k1_build_record(built) -> dict:
    """K1's build record: for its main instance at the blkp of GPS,
    BeiDou 4.096 Msps, GLONASS 8.192 Msps and GPS 16.384 Msps, what it
    uses (tk.fused_info); raises on a spill."""
    spill = spill_bytes(built)
    if spill:
        raise AssertionError(f"K1 spills {spill} bytes: {ptxas(built)}")
    return {"spill_bytes": spill, "main": {
        s.samples_per_code + 2: tk.fused_info(s.samples_per_code + 2)
        for s in (SIG, BSIG, OSIG, HSIG)}}


def acq_search_ms(device, reps: int = 20) -> float:
    """One on-chunk cold search of the main path (32 PRNs x 33 Doppler
    bins x 2048 lags, two 2 ms coherent windows, max-combined): ms per
    search, CUDA events after a warm-up."""
    acq = AcqConfig(doppler_band=8e3, coherent_ms=2, threshold=2.4)
    spc = SIG.samples_per_code
    x = IFSimulator(SIG, [SatParams(prn=3, doppler_hz=1250.0,
                                    code_phase_chips=100.3)],
                    noise_sigma=1.0, seed=7, device=device
                    ).generate_tensor(8)
    blocks = search.stack_windows(x, spc, acq)
    fd = search.code_fd_tensor(SIG, acq, device)
    dopp = torch.as_tensor(fft_acquire.doppler_grid(
        0.0, acq.doppler_band, acq.doppler_bin_step()),
        dtype=torch.float32, device=device)

    def once():
        cube = fft_acquire.acquire_cube(blocks, fd, dopp, SIG.fs, spc)
        return fft_acquire.peak_metrics(cube, samples_per_code=spc,
                                        samples_per_chip=2)["metric"]

    once()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        once()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


class _Collector:
    """PVT records and per-stage host wall time (task_health) of the
    measured window, and every event and host-path search (its epoch) of
    the run, from the telemetry bus."""

    def __init__(self):
        self.pvt = []
        self.stages = {}
        self.events = []
        self.host_searches = []
        self.enabled = False

    def __call__(self, rec):
        if rec.get("type") == "event":
            self.events.append(rec)
        if rec.get("stage") == "acquire":
            self.host_searches.append(rec["epoch_ms"])
        if not self.enabled:
            return
        if rec.get("type") == "pvt":
            self.pvt.append((rec["epoch_ms"], rec["lat_deg"],
                             rec["lon_deg"], rec["h_m"], rec["n_sv"]))
        elif rec.get("type") == "task_health":
            self.stages[rec["stage"]] = (self.stages.get(rec["stage"], 0.0)
                                         + rec["wall_s"])


def refused_modules() -> list:
    """The jax / gnsstpu modules this process has loaded (the port loads
    none)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "gnsstpu"))


def device_signal(sig, sats, n_ms: int, seed: int, device,
                  piece_ms: int | None = None) -> DevicePackedArraySource:
    """n_ms of signal from the port's simulator on the card, in one call
    or in piece_ms pieces (bounded device memory), as a 2-bit sm2 source
    resident on the card."""
    sim = IFSimulator(sig, sats, noise_sigma=1.0, seed=seed, device=device)
    piece_ms = piece_ms or n_ms
    buf = np.concatenate([sim.generate(min(piece_ms, n_ms - ms0), ms0)
                          for ms0 in range(0, n_ms, piece_ms)])
    return DevicePackedArraySource(buf, fmt="sm2", scale=1.0, device=device)


def gps_main_path(device, src=None, mesh=None) -> tuple:
    """The bench_manager configuration through the port's manager (on a
    mesh when one is given, over `src` when one is given). Returns
    (results, the sm2 source on the card, run_snapshot of the
    manager)."""
    n_ms = GPS_SECONDS * 1000
    sats, prns, recv, absent = gps_sky()
    t0 = time.perf_counter()
    if src is None:
        src = device_signal(SIG, sats, n_ms + 800, 3, device)
    setup_s = time.perf_counter() - t0
    pool = prns + absent
    cfg = gps_config(pool)
    navr = OnlineNavigator(SIG, cfg.nav, mode="lsq")
    coll = _Collector()
    tlm = Telemetry(sink=None)
    tlm.subscribe(coll)
    warm_ms, meas_ms = gps_windows(n_ms)
    reset_counts()
    mgr = gps_manager(src, cfg, pool, device=device, telemetry=tlm,
                      navigator=navr, engine="fused", mesh=mesh)
    mgr.run(warm_ms)
    coll.enabled = True
    mgr._next_reacq_ms = 0           # re-arm a search for the window
    t0 = time.perf_counter()
    recs = mgr.run(meas_ms)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    coll.enabled = False
    launches = tk.LAUNCHES["track_chunk_fused"]
    res = {
        "realtime_factor_overall": meas_ms / 1000.0 / (t1 - t0),
        "measured_ms": meas_ms,
        "wall_s": t1 - t0,
        "signal_setup_s": setup_s,
        "engine": mgr.engine,
        "live_channels_at_end": int(sum(1 for p in recs[-1].prn if p)),
        "ephemerides_decoded": len(navr.decoded),
        "pvt_solutions": len(coll.pvt),
        "k1_launches": launches,
        "summary_launches": sk.LAUNCHES["epoch_summary"],
        "decodes": up.DECODES["unpack"],
        "stage_wall_s": {k: round(v, 4) for k, v in
                         sorted(coll.stages.items())},
    }
    if coll.pvt:
        _, lat, lon, h, nsv = coll.pvt[-1]
        res["last_fix_err_m"] = position_error_m(lat, lon, h, recv)
        res["n_sv_last"] = int(nsv)
    snap = run_snapshot(mgr)
    if mesh is not None:
        st = mgr._state
        res["state_parts"] = [
            {"device": str(p.corr.sample_pos.device),
             "rows": int(p.corr.sample_pos.shape[0])} for p in st.parts] \
            if isinstance(st, Sharded) else None
    return res, src, snap


#: The prompt-stream lanes phases 29 and 35 hold bit-identical (with the
#: data component's i_p2 and q_p2 where the family has one).
STREAM_LANES = ("i_p", "q_p", "carr_doppler", "abs_sample", "carr_cycles")


def run_snapshot(mgr) -> dict:
    """A manager run's records and the prompt streams of every PRN with
    history, as host arrays."""
    recs = [(r.epoch_ms, r.prn.copy(), r.cn0_dbhz.copy(),
             r.pll_lock.copy(), r.doppler_hz.copy()) for r in mgr.records]
    streams = {}
    for prn, h in mgr.history.items():
        if h["i_p"]:
            s = mgr.prompt_stream(prn)
            streams[prn] = {k: s[k] for k in STREAM_LANES + ("i_p2", "q_p2")
                            if k in s}
    return {"records": recs, "streams": streams}


def snapshot_mismatches(a: dict, b: dict) -> list:
    """What differs, bit for bit, between two run_snapshot()s."""
    bad = []
    if len(a["records"]) != len(b["records"]):
        bad.append(f"records {len(a['records'])} vs {len(b['records'])}")
    for ra, rb in zip(a["records"], b["records"]):
        if ra[0] != rb[0] or not all(np.array_equal(x, y)
                                     for x, y in zip(ra[1:], rb[1:])):
            bad.append(f"record at {ra[0]} ms")
            break
    if sorted(a["streams"]) != sorted(b["streams"]):
        bad.append(f"stream PRNs {sorted(a['streams'])} vs "
                   f"{sorted(b['streams'])}")
    for prn in set(a["streams"]) & set(b["streams"]):
        sa, sb = a["streams"][prn], b["streams"][prn]
        for k in sorted(set(sa) | set(sb)):
            if k not in sa or k not in sb or not np.array_equal(sa[k],
                                                                sb[k]):
                bad.append(f"PRN {prn} {k}")
    return bad


def k2_inputs(C: int, n_blocks: int, device):
    """K2's tensor and static arguments: up to 12 Galileo E1B satellites
    at spread Dopplers and code phases from the port's simulator, the
    trackers started 7 Hz off each truth; channel i tracks satellite
    i mod 12."""
    prns = [11, 4, 19, 27, 2, 8, 14, 30, 23, 5, 33, 36][:min(C, 12)]
    sats = [SatParams(prn=p, doppler_hz=350.0 * i - 1900.0,
                      code_phase_chips=611.0 * i + 57.25, cn0_dbhz=48.0)
            for i, p in enumerate(prns)]
    chunk = IFSimulator(GSIG, sats, noise_sigma=1.0, seed=6,
                        device=device).generate_tensor(4 * n_blocks + 12)
    spc = GSIG.samples_per_code
    spchip = GSIG.fs / GSIG.code_freq
    ch = [sats[i % len(sats)] for i in range(C)]
    state0 = tboc.BocTrackState.init(
        np.array([int(round(s.code_phase_chips * spchip)) % spc
                  for s in ch]),
        np.array([s.doppler_hz + 7.0 for s in ch], np.float32),
        device=device)
    ctab = torch.as_tensor(tboc.code_tap_rows(GSIG, GTRK, prns),
                           device=device)[torch.as_tensor(
                               np.arange(C) % len(prns), device=device)]
    stab = torch.as_tensor(tboc.sub_tap_rows(GSIG, GTRK), device=device)
    cb = u32_tensor(np.full(C, nco.freq_to_step_u32(GSIG.if_freq, GSIG.fs)),
                    device)
    args = tboc.boc_kernel_inputs(chunk, ctab, stab, cb, state0, GTRK)
    return args, tboc.boc_kernel_kwargs(GSIG, GTRK, n_blocks=n_blocks)


def k2_compare(C: int, n_blocks: int, device) -> tuple:
    """K2's wrapper against its plain twin on the card under K2_TOL, and
    against itself on a second launch. Returns (deviations, K2's bound at
    this shape)."""
    args, kw = inputs = k2_inputs(C, n_blocks, device)
    repeat_identical(f"K2 C={C}", inputs, tk.track_chunk_boc_fused)
    blkp = kw["blkp"]
    dev, ro = twin_parity(
        f"K2 C={C}", inputs, tk.track_chunk_boc_fused,
        tk.track_chunk_boc_fused_ref, blk_lane=tk.OB_BLKSIZE,
        acc_lanes=tk.OB_ACCS,
        acc_tol=(K2_TOL["acc_rtol"], K2_TOL["acc_atol"]),
        lane_tol={name: (lane, K2_TOL[name]) for name, lane in (
            ("carr_doppler", tk.OB_CARR_DOPPLER),
            ("rem_code_phase", tk.OB_REM),
            ("rem_sub_phase", tk.OB_REM_SUB))},
        max_lsb=n_blocks * blkp)

    chunk, ctab, stab, _, finit = args[:5]
    k = tk._boc_consts(**{n: kw[n] for n in (
        "code_length", "sub_length", "ph_code", "ph_sub", "span_code",
        "span_sub", "base_code_step", "base_sub_step", "fs", "coefs")})
    f0 = finit.cpu().numpy()
    code_rows = rows_used(f0[:, tk._F_REM], ro[..., tk.OB_REM],
                          [k["span_code"]], k["ph_code"], ctab.shape[1])
    sub_rows = rows_used(f0[:, tk._F_REM_SUB], ro[..., tk.OB_REM_SUB],
                         [k["span_sub"]], k["ph_sub"], stab.shape[0])
    n_rows = (sum(len(np.unique(code_rows[c])) for c in range(C))
              + len(np.unique(sub_rows)))
    samples = float(ro[..., tk.OB_BLKSIZE].sum())
    n_bytes = (chunk.numel() * 4 + n_rows * 3 * blkp
               + 2 * finit.numel() * 4 + ro.size * 4)
    return dev, bound(n_bytes, 22.0 * samples)


def k2_times(C: int, n_blocks: int, device) -> tuple:
    return kernel_times(k2_inputs(C, n_blocks, device),
                        tk.track_chunk_boc_fused,
                        tk.track_chunk_boc_fused_ref)


def galileo_main_path(device, src=None, mesh=None) -> tuple:
    """The live Galileo E1B receiver through the port's manager (on a
    mesh when one is given, over `src` when one is given). Returns
    (results, the sm2 source on the card, run_snapshot of the
    manager)."""
    seconds, n_channels, epoch_ms, sync_every = 24, 12, 500, 4
    n_ms = seconds * 1000
    sats, prns, recv, _ = galileo_constellation(
        GSIG, 8, duration_s=seconds + 1.0, cn0_dbhz=48.0)
    t0 = time.perf_counter()
    if src is None:
        src = device_signal(GSIG, sats, n_ms + 800, 23, device)
    setup_s = time.perf_counter() - t0
    absent = [p for p in range(1, galileo_e1.NUM_PRN + 1)
              if p not in prns][:2]
    pool = prns + absent
    cfg = ReceiverConfig(
        signal=GSIG,
        acq=AcqConfig(doppler_band=9e3, coherent_ms=1, threshold=2.2,
                      doppler_step=75.0, prn_list=tuple(pool)),
        track=GTRK,
        nav=NavConfig(sol_period_ms=500, elevation_mask_deg=10.0,
                      use_tropo=False),
        n_channels=n_channels)
    navr = OnlineNavigator(GSIG, cfg.nav, retry_ms=800, mode="lsq")
    coll = _Collector()
    tlm = Telemetry(sink=None)
    tlm.subscribe(coll)
    warm_ms = 2 * sync_every * epoch_ms
    reset_counts()
    mgr = ChannelManager(
        src, cfg, device=device, telemetry=tlm, epoch_ms=epoch_ms,
        reacq_period_ms=2000, sync_every=sync_every, navigator=navr,
        prn_pool=pool, prefetch=True, readback="compact", engine="auto",
        mesh=mesh)
    mgr.run(warm_ms)
    meas_ms = n_ms - warm_ms - 2 * epoch_ms
    coll.enabled = True
    t0 = time.perf_counter()
    recs = mgr.run(meas_ms)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    coll.enabled = False
    launches = dict(tk.LAUNCHES)
    err = [float(np.linalg.norm([s["x"] - recv[0], s["y"] - recv[1],
                                 s["z"] - recv[2]]))
           for s in navr.solutions]
    res = {
        "realtime_factor_overall": meas_ms / 1000.0 / (t1 - t0),
        "measured_ms": meas_ms,
        "wall_s": t1 - t0,
        "signal_setup_s": setup_s,
        "engine": mgr.engine,
        "sky_prns": prns,
        "decoded_prns": sorted(navr.decoded),
        "live_channels_at_end": int(sum(1 for p in recs[-1].prn if p)),
        "pvt_solutions": len(navr.solutions),
        "mean_3d_err_m": float(np.mean(err)) if err else None,
        "k2_launches": launches["track_chunk_boc_fused"],
        "k1_launches": launches["track_chunk_fused"],
        "summary_launches": sk.LAUNCHES["epoch_summary"],
        "decodes": up.DECODES["unpack"],
        "stage_wall_s": {k: round(v, 4) for k, v in
                         sorted(coll.stages.items())},
    }
    return res, src, run_snapshot(mgr)


def l3_sky(prns, dopplers, rates, code_phases, n_ms: int, seed: int,
           cn0_dbhz: float = 48.0) -> tuple:
    """L3OC satellites as the reference simulator makes them
    (tests/test_glonass_l3.py::overlay_streams): per satellite a pilot
    code(prn) x NH(10) and, in quadrature, a data code(prn + 32) x
    Barker(5) x its own L3_BITS seeded random bits, rate-1/2 encoded (the
    codeword repeats). Returns (SatParams list, {prn: bits})."""
    rng = np.random.default_rng(seed)
    sats, bits = [], {}
    nh = np.resize(glonass_l3.NH10.astype(np.float32), n_ms)
    barker = np.resize(glonass_l3.BARKER5.astype(np.float32), n_ms)
    for prn, fd, rate, cp in zip(prns, dopplers, rates, code_phases):
        b = rng.integers(0, 2, L3_BITS).astype(np.int8)
        sym = 1.0 - 2.0 * conv_encode(b, polys=l3nav.L3_POLYS,
                                      invert=l3nav.L3_INVERT)
        data = np.repeat(np.resize(sym, -(-n_ms // 5)), 5)[:n_ms] * barker
        common = dict(doppler_hz=float(fd), doppler_rate=float(rate),
                      code_phase_chips=float(cp), cn0_dbhz=cn0_dbhz)
        sats += [SatParams(prn=glonass_l3.pilot_prn(prn), nav_bits=nh,
                           carrier_phase=0.0, **common),
                 SatParams(prn=glonass_l3.data_prn(prn), nav_bits=data,
                           carrier_phase=np.pi / 2, **common)]
        bits[prn] = b
    return sats, bits


def k3_inputs(C: int, n_blocks: int, device):
    """K3's tensor and static arguments: up to 12 L3OC satellites at
    spread Dopplers and code phases from the port's simulator at 24 Msps,
    the trackers started 7 Hz off each truth; channel i tracks satellite
    i mod 12."""
    n_sv = min(C, 12)
    prns = [3, 7, 11, 14, 18, 22, 26, 30, 1, 5, 9, 27][:n_sv]
    dopp = [600.0 * i - 3300.0 for i in range(n_sv)]
    cps = [853.0 * i + 41.25 for i in range(n_sv)]
    sats, _ = l3_sky(prns, dopp, [0.0] * n_sv, cps, n_blocks + 3, seed=9)
    chunk = IFSimulator(LSIG, sats, noise_sigma=1.0, seed=9,
                        device=device).generate_tensor(n_blocks + 3)
    spc = LSIG.samples_per_code
    spchip = LSIG.fs / LSIG.code_freq
    ch = np.arange(C) % n_sv
    state0 = tscan.TrackState.init(
        np.array([int(round(cps[i] * spchip)) % spc for i in ch]),
        np.array([dopp[i] + 7.0 for i in ch], np.float32),
        aid_div=LTRK.aid_div, device=device)
    tab = torch.as_tensor(tdual.dual_tap_rows(LSIG, LTRK, prns),
                          device=device)[torch.as_tensor(ch, device=device)]
    cb = u32_tensor(np.full(C, nco.freq_to_step_u32(LSIG.if_freq, LSIG.fs)),
                    device)
    args = tdual.dual_kernel_inputs(chunk, tab, cb, state0, LTRK)
    return args, tdual.dual_kernel_kwargs(LSIG, LTRK, n_blocks=n_blocks)


def k3_compare(C: int, n_blocks: int, device) -> tuple:
    """K3's wrapper against its plain twin on the card under K3_TOL, and
    against itself on a second launch. Returns (deviations, K3's bound at
    this shape)."""
    args, kw = inputs = k3_inputs(C, n_blocks, device)
    repeat_identical(f"K3 C={C}", inputs, tk.track_chunk_dual_fused)
    blkp = kw["blkp"]
    dev, ro = twin_parity(
        f"K3 C={C}", inputs, tk.track_chunk_dual_fused,
        tk.track_chunk_dual_fused_ref, blk_lane=tk.OD_BLKSIZE,
        acc_lanes=tk.OD_ACCS,
        acc_tol=(K3_TOL["acc_rtol"], K3_TOL["acc_atol"]),
        lane_tol={name: (lane, K3_TOL[name]) for name, lane in (
            ("carr_doppler", tk.OD_CARR_DOPPLER),
            ("rem_code_phase", tk.OD_REM))},
        max_lsb=n_blocks * blkp)

    chunk, tab, _, finit = args[:4]
    k = tk._dual_consts(**{n: kw[n] for n in (
        "code_length", "phases_per_chip", "span_chips", "base_code_step",
        "fs", "coefs")})
    rows = rows_used(finit[:, tk._F_REM].cpu().numpy(), ro[..., tk.OD_REM],
                     [k["span"]], k["ph"], tab.shape[1])
    n_rows = sum(len(np.unique(rows[c])) for c in range(C))
    samples = float(ro[..., tk.OD_BLKSIZE].sum())
    n_bytes = (chunk.numel() * 4 + n_rows * 6 * blkp
               + 2 * finit.numel() * 4 + ro.size * 4)
    return dev, bound(n_bytes, 24.0 * samples)


def k3_floor_ms(C: int, n_blocks: int, device) -> float:
    """K3's time per launch on blocks of 64 samples (zero signal, one tap
    row): what a block costs beyond its samples, that is the cluster
    barriers, the reduction, the leader's loop update, the LO angles and
    one load round trip."""
    blkp = 64
    i64 = torch.zeros((C,), dtype=torch.int64, device=device)
    args = (torch.zeros((n_blocks * blkp + 256, 2), device=device),
            torch.ones((C, 1, 6, tk.plane_stride(blkp)), dtype=torch.int8,
                       device=device),
            torch.zeros((C,), dtype=torch.int32, device=device),
            torch.zeros((C, tk.NF), device=device), i64, i64.clone())
    kw = dict(tdual.dual_kernel_kwargs(LSIG, LTRK, n_blocks=n_blocks),
              blkp=blkp)
    return kernel_times((args, kw), tk.track_chunk_dual_fused, None)[0]


def k3_times(C: int, n_blocks: int, device, twin: bool = True) -> tuple:
    return kernel_times(k3_inputs(C, n_blocks, device),
                        tk.track_chunk_dual_fused,
                        tk.track_chunk_dual_fused_ref if twin else None)


def l3_bits_recovered(h: dict, bits: np.ndarray) -> tuple:
    """(overlay sync, data bits recovered bit-exact) from one satellite's
    prompt history, by tests/test_glonass_l3.py's chain: the NH(10) epoch
    from the pilot prompts after the slot's first L3_SETTLE_MS, then the
    Barker wipe and a Viterbi decode of the data prompts (q_p2) over one
    codeword, searching the codeword phase on the 5 ms symbol grid over
    the history's last two codewords."""
    sync = l3nav.sync_overlay(h["i_p"][L3_SETTLE_MS:])
    if not sync.found:
        return sync, False
    q = h["q_p2"] * sync.polarity
    cw_ms = 10 * (len(bits) + 6)
    start = L3_SETTLE_MS + sync.first_ms          # an NH epoch
    base = start + 10 * max(0, (len(q) - 2 * cw_ms - start) // 10)
    barker = glonass_l3.BARKER5.astype(np.float64)
    for s0 in range(base, base + cw_ms, 5):
        seg = q[s0: s0 + cw_ms]
        if len(seg) < cw_ms:
            break
        dec = viterbi_decode(seg.reshape(-1, 5) @ barker,
                             polys=l3nav.L3_POLYS, invert=l3nav.L3_INVERT)
        if np.array_equal(dec.astype(np.int8), bits):
            return sync, True
    return sync, False


def l3_main_path(device, k3_ms: float, src=None, mesh=None) -> tuple:
    """glonass_l3oc_live_12ch through the port's manager: 8 satellites in
    the sky, 2 absent ones in the pool, 9 s of signal made in 1 s pieces
    (2 s warm-up, 6 s measured). k3_ms: K3's time per launch, for its
    share of the wall; on a mesh when one is given, over `src` when one
    is given. Returns (results, the sm2 source on the card, run_snapshot
    of the manager)."""
    seconds, n_channels, epoch_ms, sync_every = 9, 12, 500, 2
    n_ms, meas_ms = seconds * 1000, 6000
    prns, absent = L3_SKY, L3_ABSENT
    rng = np.random.default_rng(31)
    dopp = rng.permutation(np.linspace(-3600.0, 3600.0, len(prns)))
    rates = rng.uniform(-0.55, 0.55, len(prns))
    cps = (np.arange(len(prns)) * 10230.0 / len(prns)
           + rng.uniform(0.0, 1000.0, len(prns)))
    sats, bits = l3_sky(prns, dopp, rates, cps, n_ms + 20, seed=32)
    t0 = time.perf_counter()
    if src is None:
        src = device_signal(LSIG, sats, n_ms, 33, device, piece_ms=1000)
    setup_s = time.perf_counter() - t0
    pool = prns + absent
    cfg = ReceiverConfig(
        signal=LSIG,
        acq=AcqConfig(doppler_band=8e3, coherent_ms=1, threshold=2.5,
                      doppler_step=250.0, prn_list=tuple(pool)),
        track=LTRK, nav=NavConfig(), n_channels=n_channels)
    navr = OnlineNavigator(LSIG, cfg.nav, mode="lsq")
    coll = _Collector()
    tlm = Telemetry(sink=None)
    tlm.subscribe(coll)
    warm_ms = 2 * sync_every * epoch_ms
    reset_counts()
    mgr = ChannelManager(
        src, cfg, device=device, telemetry=tlm, epoch_ms=epoch_ms,
        reacq_period_ms=1000, sync_every=sync_every, navigator=navr,
        prn_pool=pool, prefetch=True, readback="compact", engine="auto",
        mesh=mesh)
    mgr.run(warm_ms)
    k3_warm = tk.LAUNCHES["track_chunk_dual_fused"]
    coll.enabled = True
    t0 = time.perf_counter()
    recs = mgr.run(meas_ms)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    coll.enabled = False
    launches = dict(tk.LAUNCHES)
    t_end = (recs[-1].epoch_ms + epoch_ms) * 1e-3
    sky = {}
    for prn, fd, rate in zip(prns, dopp, rates):
        slot = next((i for i, s in enumerate(mgr.slots) if s.prn == prn),
                    None)
        row = {"state": mgr.slots[slot].state.value if slot is not None
               else "idle",
               "events": [(e["epoch_ms"], e["what"], e.get("why"),
                           e.get("doppler_hz")) for e in coll.events
                          if e.get("prn") == prn
                          and e["what"] != "channel_confirmed"]}
        if slot is not None:
            h = mgr.prompt_stream(prn)
            # The last epoch's mean Doppler against the truth at its
            # middle (one block's value carries the PLL's jitter).
            row["doppler_err_hz"] = float(
                h["carr_doppler"][-epoch_ms:].mean()
                - (fd + rate * (t_end - 0.5 * epoch_ms * 1e-3)))
            row["cn0_dbhz"] = float(recs[-1].cn0_dbhz[slot])
            sync, ok = l3_bits_recovered(h, bits[prn])
            row.update(overlay_found=bool(sync.found),
                       overlay_quality=float(sync.quality), bits_exact=ok)
        sky[prn] = row
    wall = t1 - t0
    k3_meas = launches["track_chunk_dual_fused"] - k3_warm
    res = {
        "realtime_factor_overall": meas_ms / 1000.0 / wall,
        "measured_ms": meas_ms,
        "wall_s": wall,
        "signal_setup_s": setup_s,
        "engine": mgr.engine,
        "sky": sky,
        "confirmed_prns": sorted({e["prn"] for e in coll.events
                                  if e["what"] == "channel_confirmed"}),
        "absent_prns": absent,
        "live_nav_unsupported_events": sum(
            e["what"] == "live_nav_unsupported" for e in coll.events),
        "k3_launches": launches["track_chunk_dual_fused"],
        "k3_launches_measured": k3_meas,
        "k3_share_of_wall": k3_meas * k3_ms * 1e-3 / wall,
        "k1_launches": launches["track_chunk_fused"],
        "k2_launches": launches["track_chunk_boc_fused"],
        "summary_launches": sk.LAUNCHES["epoch_summary"],
        "decodes": up.DECODES["unpack"],
        "stage_wall_s": {k: round(v, 4) for k, v in
                         sorted(coll.stages.items())},
    }
    return res, src, run_snapshot(mgr)


def k1_family_path(device, *, sig, trk, acq, sats, sky, absent, recv,
                   seconds: float, seed: int, retry_ms: int,
                   confirm_epochs: int, reacq_period_ms: int,
                   k1_ms: float, epoch_ms: int = 100,
                   sync_every: int = 4) -> dict:
    """One of K1's live families through the port's manager, as the
    Galileo path: 12 slots over the sky's satellites plus the absent
    PRNs in the pool, the signal resident on the card (sm2), prefetch,
    compact readback, the navigator armed, a warm-up of two superepochs,
    then the rest measured. k1_ms: K1's time per launch at this path's
    launch shape, for its share of the wall. Counts the on-chunk
    searches (reacquisition riding a superepoch's chunk)."""
    n_ms = int(round(seconds * 1000))
    t0 = time.perf_counter()
    src = device_signal(sig, sats, n_ms + 400, seed, device, piece_ms=4000)
    setup_s = time.perf_counter() - t0
    pool = list(sky) + list(absent)
    cfg = ReceiverConfig(
        signal=sig, acq=dataclasses.replace(acq, prn_list=tuple(pool)),
        track=trk,
        nav=NavConfig(sol_period_ms=500, elevation_mask_deg=10.0,
                      use_tropo=False),
        n_channels=12)
    navr = OnlineNavigator(sig, cfg.nav, retry_ms=retry_ms, mode="lsq")
    coll = _Collector()
    tlm = Telemetry(sink=None)
    tlm.subscribe(coll)
    warm_ms = 2 * sync_every * epoch_ms
    reset_counts()
    mgr = ChannelManager(
        src, cfg, device=device, telemetry=tlm, epoch_ms=epoch_ms,
        reacq_period_ms=reacq_period_ms, confirm_epochs=confirm_epochs,
        sync_every=sync_every, navigator=navr, prn_pool=pool,
        prefetch=True, readback="compact", engine="auto")
    searches = []
    chunk_search = mgr._chunk_search

    def counted(chunk, base, need_len, want):
        out = chunk_search(chunk, base, need_len, want)
        if out[0] is not None:
            searches.append(base)
        return out

    mgr._chunk_search = counted
    mgr.run(warm_ms)
    k1_warm = tk.LAUNCHES["track_chunk_fused"]
    meas_ms = n_ms - warm_ms - 2 * epoch_ms
    coll.enabled = True
    t0 = time.perf_counter()
    recs = mgr.run(meas_ms)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    coll.enabled = False
    launches = dict(tk.LAUNCHES)
    wall = t1 - t0
    k1_meas = launches["track_chunk_fused"] - k1_warm
    err = [float(np.linalg.norm([s["x"] - recv[0], s["y"] - recv[1],
                                 s["z"] - recv[2]]))
           for s in navr.solutions]
    return {
        "realtime_factor_overall": meas_ms / 1000.0 / wall,
        "measured_ms": meas_ms,
        "wall_s": wall,
        "signal_setup_s": setup_s,
        "engine": mgr.engine,
        "blkp": sig.samples_per_code + 2,
        "sky_prns": sorted(sky),
        "absent_prns": list(absent),
        "decoded_prns": sorted(navr.decoded),
        "confirmed_prns": sorted({e["prn"] for e in coll.events
                                  if e["what"] == "channel_confirmed"}),
        "live_channels_at_end": int(sum(1 for p in recs[-1].prn if p)),
        "pvt_solutions": len(navr.solutions),
        "mean_3d_err_m": float(np.mean(err)) if err else None,
        "on_chunk_searches": len(searches),
        "host_searches": coll.host_searches,
        "k1_launches": launches["track_chunk_fused"],
        "k1_launches_measured": k1_meas,
        "k1_share_of_wall": k1_meas * k1_ms * 1e-3 / wall,
        "k2_launches": launches["track_chunk_boc_fused"],
        "k3_launches": launches["track_chunk_dual_fused"],
        "summary_launches": sk.LAUNCHES["epoch_summary"],
        "decodes": up.DECODES["unpack"],
        "stage_wall_s": {k: round(v, 4) for k, v in
                         sorted(coll.stages.items())},
    }, mgr


def k1_family_checks(name: str, res: dict, min_fixes: int,
                     max_err_m: float) -> None:
    """The live checks of a K1 family path; raises on a failure."""
    refused = refused_modules()
    sky = res["sky_prns"]
    checks = {
        "every sky SV's ephemeris decoded":
            set(sky) <= set(res["decoded_prns"]),
        f"pvt_solutions >= {min_fixes}": res["pvt_solutions"] >= min_fixes,
        f"mean_3d_err_m < {max_err_m:g}": (
            res["mean_3d_err_m"] is not None
            and res["mean_3d_err_m"] < max_err_m),
        "live_channels_at_end >= sky - 1":
            res["live_channels_at_end"] >= len(sky) - 1,
        "no absent PRN confirmed":
            not set(res["confirmed_prns"]) & set(res["absent_prns"]),
        "k1_launches > 0, K2 and K3 none": (res["k1_launches"] > 0
                                            and res["k2_launches"] == 0
                                            and res["k3_launches"] == 0),
        "no jax or gnsstpu module loaded": not refused,
        "realtime_factor_overall >= 1": res["realtime_factor_overall"] >= 1,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{name} checks failed: {failed} "
                             f"(modules: {refused[:5]})")


def beidou_main_path(device, k1_ms: float) -> tuple:
    """beidou_b1i_live_12ch: tests/test_live_families.py's live BeiDou
    receiver widened to 12 slots: every satellite of
    beidou_constellation above 15 degrees (the reference's 5 and more),
    48 dB-Hz, 2 absent PRNs in the pool, 4.096 Msps (K1 at blkp 4,098),
    40 s of signal. The reference's BD_NMS + 8 s (28.6 s) holds
    subframes 1-3 (2-20 s) only for a channel tracked from the start. A
    1 ms search can land one 125 Hz bin off; this loop's FLL (k3 = T *
    fll_bw / 0.25) then corrects ~0.1% of the error per block, the slot
    fails its 1.2 s confirmation and is searched again at the next 2 s
    reacquisition, after subframe 1 began. Its ephemeris then needs the
    next frame's subframe 1 (32-38 s). gnsstpu's own receiver does the
    same on this signal (tools/beidou_pull_in.py)."""
    seconds = 40.0
    sats, sky, recv, _ = beidou_constellation(BSIG, None, duration_s=seconds,
                                              cn0_dbhz=48.0)
    absent = [p for p in range(1, get_signal(BSIG.signal).num_prn + 1)
              if p not in sky][:2]
    acq = AcqConfig(doppler_band=12e3, coherent_ms=1, threshold=2.0,
                    doppler_step=125.0)
    return k1_family_path(
        device, sig=BSIG, trk=BTRK, acq=acq, sats=sats, sky=sky,
        absent=absent, recv=recv, seconds=seconds, seed=17, retry_ms=500,
        confirm_epochs=12, reacq_period_ms=2000, k1_ms=k1_ms)


#: The live GLONASS sky of tests/test_glonass.py:238-240.
GFIX_RECV = np.array([3427947.0, 603774.0, 5326967.0])
GFIX_TB = 675                     # 11:15:00 Moscow-day time
GFIX_T0 = GFIX_TB * 60 + 30.0     # string 1 data start


def glonass_main_path(device, k1_ms: float) -> tuple:
    """glonass_l1of_live_12ch: tests/test_glonass.py's live GLONASS
    receiver at the 8.192 Msps front end of tests/test_glonass.py:19 (K1
    at blkp 8,194), widened to 12 slots: 6 satellites on their
    frequency channels, 48 dB-Hz, registry PRNs 1 and 13 absent in the
    pool, 2 s reacquisition (the on-chunk FDMA search runs on the card),
    12 s of signal."""
    seconds = 12.0
    gephs = make_glonass_constellation(GFIX_RECV, GFIX_TB, n=6)
    sats, _ = build_scenario_glonass(OSIG, gephs, GFIX_RECV, GFIX_T0,
                                     duration_s=seconds + 0.4,
                                     cn0_dbhz=48.0, n_strings=6)
    acq = AcqConfig(doppler_band=14e3, coherent_ms=2, threshold=2.5,
                    fine_doppler_ms=10)
    return k1_family_path(
        device, sig=OSIG, trk=OTRK, acq=acq, sats=sats, sky=sorted(gephs),
        absent=[1, 13], recv=GFIX_RECV, seconds=seconds, seed=31,
        retry_ms=300, confirm_epochs=6, reacq_period_ms=2000, k1_ms=k1_ms)


def chunk_search_ms(mgr, want=None, reps: int = 10) -> tuple:
    """A live manager's on-chunk search for the PRNs in `want` (default:
    its pool) on its source's first chunk: ms per search (CUDA events
    after a warm-up) and the device memory it takes beyond what is
    allocated before it. Returns (that record, the search's [3, P] lanes
    on the host)."""
    want = list(mgr.pool if want is None else want)
    chunk = mgr._to_device(mgr.source.read_packed(0, mgr._chunk_len))
    search = mgr._make_acq_chunk_fn()
    lanes = search(chunk, want).cpu().numpy()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        search(chunk, want)
    t1.record()
    torch.cuda.synchronize()
    return {"ms": t0.elapsed_time(t1) / reps,
            "peak_extra_mb": (torch.cuda.max_memory_allocated() - base)
            / 2 ** 20,
            "grid_rows": int(len(mgr._acq_doppler)
                             * (mgr.sd.num_prn if mgr._acq_offs is not None
                                else 1))}, lanes


def l3_chunk_search_path(device, src) -> dict:
    """The L3OC on-chunk search at the live cell's shape (24 Msps, 1 ms,
    33 Doppler bins, 2 windows) on `src`'s first chunk, timed by CUDA
    events for three `want`s: every pilot PRN (the whole 63-code bank),
    the pool (sky + absent) and the two absent PRNs. Each reads the
    absent PRNs' lanes; their mismatches between the searches, and the
    nonzero lanes of PRNs the last did not search, are failures."""
    cfg = ReceiverConfig(
        signal=LSIG,
        acq=AcqConfig(doppler_band=8e3, coherent_ms=1, threshold=2.5,
                      doppler_step=250.0),
        track=LTRK, nav=NavConfig(), n_channels=12)
    pool = L3_SKY + L3_ABSENT
    mgr = ChannelManager(src, cfg, device=device, epoch_ms=500,
                         sync_every=2, prn_pool=pool, prefetch=True,
                         readback="compact", engine="auto")
    P = mgr.sd.num_prn
    rows = [p - 1 for p in L3_ABSENT]
    out, lanes = {}, {}
    for tag, want in (("bank", range(1, 33)), ("pool", pool),
                      ("absent", L3_ABSENT)):
        rec, lanes[tag] = chunk_search_ms(mgr, want)
        rec["codes"] = len(search.bank_rows(LSIG.signal, P, want)[0])
        out[tag] = rec
    del mgr
    out["absent_lanes"] = lanes["absent"][:, rows].tolist()
    out["failed"] = [
        f"absent PRNs' lanes differ: {tag} / absent" for tag in ("bank",
                                                                 "pool")
        if not np.array_equal(lanes[tag][:, rows], lanes["absent"][:, rows])
    ] + (["a PRN not searched reads nonzero"]
         if np.delete(lanes["absent"], rows, axis=1).any() else [])
    return out


def weak_tier_path(device) -> dict:
    """tests/test_pipeline.py:270-312 on the card: GLONASS L1OF 4.096
    Msps, channel 5 from the start and channel 12 from 400 ms, a 4 ms x
    15 noncoherent search longer than one superepoch chunk, summed on the
    card across chunks of the prefetch pipeline (20 ms epochs in pairs),
    1.6 s."""
    sig = SignalConfig(signal="glonass_l1of", if_freq=0.0, fs=4.096e6,
                       code_freq=0.511e6, code_length=511,
                       fdma_step=562.5e3, complex_iq=True)
    step = 562.5e3
    sats = [SatParams(prn=5, doppler_hz=1100.0, if_offset_hz=-3 * step,
                      code_phase_chips=120.5, cn0_dbhz=47.0),
            SatParams(prn=12, doppler_hz=-1700.0, if_offset_hz=4 * step,
                      code_phase_chips=333.25, cn0_dbhz=46.0)]
    early = IFSimulator(sig, sats[:1], noise_sigma=1.0, seed=3,
                        device=device).generate(400)
    late = IFSimulator(sig, sats, noise_sigma=1.0, seed=3,
                       device=device).generate(1300, ms0=400)
    cfg = ReceiverConfig(
        signal=sig,
        acq=AcqConfig(doppler_band=5e3, coherent_ms=4, noncoherent=15,
                      threshold=1.8, prn_list=(5, 12), fine_doppler_ms=10,
                      doppler_step=125.0),
        track=TrackConfig(dll_bw=1.0), n_channels=3)
    coll = _Collector()
    tlm = Telemetry(sink=None)
    tlm.subscribe(coll)
    coll.enabled = True
    mgr = ChannelManager(
        ArraySource(np.concatenate([early, late])), cfg, device=device,
        telemetry=tlm, epoch_ms=20, reacq_period_ms=300,
        cn0_drop_dbhz=35.0, prn_pool=[5, 12], sync_every=2, prefetch=True)
    steps = []
    wk_step = mgr._wk_step

    def counted(chunk, base, need_len):
        out = wk_step(chunk, base, need_len)
        steps.append((out[0], None if mgr._acq_wk is None
                      else mgr._acq_wk["cube"].device.type))
        return out

    mgr._wk_step = counted
    t0 = time.perf_counter()
    recs = mgr.run(1600)
    torch.cuda.synchronize()
    starts = [(e["prn"], e["epoch_ms"]) for e in coll.events
              if e["what"] == "channel_start"]
    return {
        "wall_s": time.perf_counter() - t0,
        "chunk_shorter_than_search": mgr._chunk_len
        < mgr._acq_samples_needed_chunk(),
        "channel_starts": starts,
        "host_searches": coll.host_searches,
        "weak_steps": [st for st, _ in steps],
        "cube_devices": sorted({d for _, d in steps if d}),
        "live_at_end": sorted(int(p) for p in recs[-1].prn if p),
    }


def checkpoint_path(device) -> dict:
    """tests/test_runtime.py:252-325 on the card: GPS 2.048 Msps, PRNs 5
    and 12, 2-bit wire resident on the card; 800 ms, save the channel
    bank, restore it into a new manager and run 600 ms more, against one
    uninterrupted 1,400 ms run."""
    sats = [SatParams(prn=5, doppler_hz=900.0, code_phase_chips=200.5,
                      cn0_dbhz=47.0),
            SatParams(prn=12, doppler_hz=-1500.0, code_phase_chips=700.25,
                      cn0_dbhz=46.0)]
    src = device_signal(SIG, sats, 1560, 3, device)
    cfg = ReceiverConfig(
        signal=SIG,
        acq=AcqConfig(doppler_band=6e3, coherent_ms=2, threshold=2.4,
                      prn_list=(5, 12), fine_doppler_ms=10),
        track=TrackConfig(dll_bw=1.0), n_channels=3)

    def mk(coll):
        tlm = Telemetry(sink=None)
        tlm.subscribe(coll)
        coll.enabled = True
        return ChannelManager(src, cfg, device=device, telemetry=tlm,
                              epoch_ms=100, reacq_period_ms=400,
                              cn0_drop_dbhz=35.0, prn_pool=[5, 12],
                              sync_every=2)

    m1 = mk(_Collector())
    m1.run(800)
    after = _Collector()
    m2 = mk(after)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bank.npz")
        m1.save_checkpoint(path)
        meta = m2.restore_checkpoint(path)
    state_devices = sorted({t.device.type for t in _state_leaves(m2._state)})
    m2.run(600)
    m0 = mk(_Collector())
    m0.run(1400)
    cph = {}
    for prn in (5, 12):
        a0, a2 = m0.history[prn]["_cph"], m2.history[prn]["_cph"]
        n0 = sum(len(x) for x in m0.history[prn]["i_p"])
        n2 = (m2.history[prn]["evicted"]
              + sum(len(x) for x in m2.history[prn]["i_p"]))
        cph[prn] = {"acc_equal": a2.acc == a0.acc,
                    "phase_u32_equal": a2.phase_u32 == a0.phase_u32,
                    "last_delta_equal": a2.last_delta == a0.last_delta,
                    "blocks_equal": n2 == n0}
    return {
        "slots_saved": meta["slots"],
        "restored_state_on": state_devices,
        "channel_starts_after_resume": sum(
            e["what"] == "channel_start" for e in after.events),
        "host_searches_after_resume": after.host_searches,
        "live_after_resume": sorted(s.prn for s in m2.slots if s.prn),
        "cph": cph,
    }


def _state_leaves(tree):
    if hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _state_leaves(getattr(tree, f))]
    return [tree]


class _PeakFill(threading.Thread):
    """Samples a RingFifo's fill every 5 ms until stopped; .peak is the
    most blocks it held."""

    def __init__(self, fifo):
        super().__init__(daemon=True)
        self.fifo, self.peak = fifo, 0
        self.halt = threading.Event()

    def run(self):
        while not self.halt.wait(0.005):
            self.peak = max(self.peak, self.fifo.stats()["count"])


class _StationClient(threading.Thread):
    """A station on loopback: reads the receiver's records through a
    StationSocket, counts them by type and, once `after_pvt` fixes have
    arrived, sends one command."""

    def __init__(self, port: int, command: dict, after_pvt: int):
        super().__init__(daemon=True)
        self.link = StationSocket("127.0.0.1", port)
        self.command, self.after_pvt = command, after_pvt
        self.counts: dict = {}
        self.sent_after_ms = None
        self.halt = threading.Event()

    def run(self):
        try:
            while not self.halt.wait(0.02):
                for line in self.link.read_lines():
                    rec = json.loads(line)
                    t = rec.get("type")
                    self.counts[t] = self.counts.get(t, 0) + 1
                    if (t == "pvt" and self.sent_after_ms is None
                            and self.counts[t] >= self.after_pvt):
                        self.link.send_command(self.command)
                        self.sent_after_ms = rec["epoch_ms"]
                if self.link.closed:
                    return
        finally:
            self.link.close()


def _send_paced(port: int, wire: bytes, bps: float, piece: int) -> None:
    """Send `wire` over TCP in `piece`-byte writes, paced at `bps` bytes a
    second, then close (the producer's end of stream)."""
    tx = socket.create_connection(("127.0.0.1", port), timeout=30.0)
    try:
        t0 = time.monotonic()
        for i in range(0, len(wire), piece):
            dt = t0 + i / bps - time.monotonic()
            if dt > 0:
                time.sleep(dt)
            tx.sendall(wire[i: i + piece])
    finally:
        tx.close()


def history_blocks(sig, epoch_ms: int, sync_every: int, wire) -> int:
    """A live stream's history and FIFO depth in blocks, as the port's
    CLI sizes them for a prefetching manager (sources.stream_blocks)."""
    chunk = ChannelManager.chunk_samples(sig, epoch_ms,
                                         sync_every=sync_every,
                                         prefetch=True, wire=wire)
    return stream_blocks(chunk, sig.samples_per_code)


def gps_tcp_live_path(device, wire: np.ndarray, k1_ms: float,
                      pace: float = 8.0) -> dict:
    """gps_l1_tcp_live_12ch: the GPS main path's configuration fed as a
    radio feeds it: a sender thread writes the signal's 2-bit sm2 bytes
    to a TcpStreamProducer(raw=True) on loopback at `pace` x real time;
    the bytes cross the port's RingFifo into a PackedStreamSource and
    the manager uploads them packed. A StationServer fans the telemetry
    out to a StationSocket client, which masks an absent PRN after 3
    fixes. The run ends on the producer's end of stream."""
    sats, prns, recv, absent = gps_sky()
    pool = prns + absent
    cfg = gps_config(pool)
    epoch_ms, sync_every = GPS_EPOCH_MS, GPS_SYNC
    blk = SIG.samples_per_code
    bpb = up.wire_bytes("sm2", blk)
    blocks = history_blocks(SIG, epoch_ms, sync_every, "sm2")
    wire = np.asarray(wire, np.uint8)
    n_sent = len(wire) // bpb
    wire = wire[: n_sent * bpb].tobytes()
    signal_ms = n_sent * blk * 1000 // int(SIG.fs)
    fifo = native.RingFifo(depth=blocks, block_bytes=bpb)
    prod = TcpStreamProducer(fifo, blk, fmt="sm2", raw=True,
                             timeout_s=60.0).start()
    src = PackedStreamSource(fifo, blk, fmt="sm2", history_blocks=blocks,
                             timeout_s=60.0)
    navr = OnlineNavigator(SIG, cfg.nav, mode="lsq")
    coll = _Collector()
    tlm = Telemetry(sink=None)
    tlm.subscribe(coll)
    srv = StationServer()
    srv.attach(tlm)
    mask_prn = absent[0]
    client = _StationClient(srv.port, {"cmd": "mask", "prn": mask_prn},
                            after_pvt=3)
    sender = threading.Thread(
        target=_send_paced, args=(prod.port, wire, pace * bpb * 1000.0,
                                  64 * bpb), daemon=True)
    fill = _PeakFill(fifo)
    t_setup = time.perf_counter()
    try:
        client.start()
        deadline = time.monotonic() + 10.0
        while srv.n_clients() < 1:
            if time.monotonic() > deadline:
                raise AssertionError("station client never connected")
            time.sleep(0.01)
        reset_counts()
        mgr = gps_manager(src, cfg, list(pool), device=device,
                          telemetry=tlm, navigator=navr, engine="fused",
                          commands=srv.commands)
        fill.start()
        sender.start()
        warm_ms = 2 * sync_every * epoch_ms
        mgr.run(warm_ms)
        k1_warm = tk.LAUNCHES["track_chunk_fused"]
        ms0 = mgr.clock_ms
        coll.enabled = True
        t0 = time.perf_counter()
        recs = mgr.run(10 * signal_ms)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        coll.enabled = False
        sender.join(timeout=60.0)
        if sender.is_alive():
            raise AssertionError("sender thread did not finish")
    finally:
        fill.halt.set()
        prod.stop()
        srv.close()
        client.halt.set()
        for t in (fill, client, sender):
            if t.ident is not None:
                t.join(timeout=30.0)
        prod.thread.join(timeout=30.0)
    launches = dict(tk.LAUNCHES)
    wall = t1 - t0
    k1_meas = launches["track_chunk_fused"] - k1_warm
    stats = fifo.stats()
    inside = [r for r in recs if r.epoch_ms + epoch_ms <= signal_ms]
    res = {
        "realtime_factor_overall": (mgr.clock_ms - ms0) / 1000.0 / wall,
        "pace_x_realtime": pace,
        "measured_ms": mgr.clock_ms - ms0,
        "wall_s": wall,
        "setup_s": t0 - t_setup,
        "signal_ms": signal_ms,
        "blocks_sent": n_sent,
        "fifo": stats,
        "producer_overruns": prod.overruns,
        "fifo_depth_blocks": blocks,
        "fifo_peak_fill_blocks": fill.peak,
        "history_blocks": blocks,
        "chunk_samples": mgr._chunk_len,
        "ended_on_end_of_stream": any(
            e["what"] == "end_of_data" for e in coll.events)
        and src.ended_at(src.position()),
        "engine": mgr.engine,
        "live_channels_at_last_epoch_in_signal": int(
            sum(1 for p in inside[-1].prn if p)) if inside else 0,
        "last_epoch_in_signal_ms": inside[-1].epoch_ms if inside else None,
        "ephemerides_decoded": len(navr.decoded),
        "station_records": dict(sorted(client.counts.items())),
        "mask_prn": mask_prn,
        "mask_sent_after_fix_at_ms": client.sent_after_ms,
        "mask_command_ok": [e["epoch_ms"] for e in coll.events
                            if e["what"] == "command_ok"
                            and "mask" in e.get("raw", "")],
        "mask_prn_in_pool": mask_prn in mgr.pool,
        "k1_launches": launches["track_chunk_fused"],
        "k1_launches_measured": k1_meas,
        "k1_share_of_wall": k1_meas * k1_ms * 1e-3 / wall,
        "k2_launches": launches["track_chunk_boc_fused"],
        "k3_launches": launches["track_chunk_dual_fused"],
        "summary_launches": sk.LAUNCHES["epoch_summary"],
        "decodes": up.DECODES["unpack"],
        "stage_wall_s": {k: round(v, 4) for k, v in
                         sorted(coll.stages.items())},
    }
    # The last superepoch runs past the end of the stream on zero bytes:
    # fixes (as live channels) are read inside the signal.
    fixes = [f for f in coll.pvt if f[0] + epoch_ms <= signal_ms]
    res["pvt_solutions"] = len(fixes)
    res["pvt_solutions_past_the_end"] = len(coll.pvt) - len(fixes)
    if fixes:
        t_fix, lat, lon, h, _ = fixes[-1]
        res["last_fix_ms"] = t_fix
        res["last_fix_err_m"] = position_error_m(lat, lon, h, recv)
    if len(fixes) < len(coll.pvt):
        _, lat, lon, h, _ = coll.pvt[-1]
        res["fix_err_m_past_the_end"] = position_error_m(lat, lon, h, recv)
    return res


def gps_tcp_checks(res: dict) -> None:
    refused = refused_modules()
    st = res["station_records"]
    checks = {
        "live channels >= 10": res["live_channels_at_last_epoch_in_signal"]
        >= 10,
        "ephemerides_decoded >= 8": res["ephemerides_decoded"] >= 8,
        "pvt_solutions >= 10": res["pvt_solutions"] >= 10,
        "last_fix_err_m < 100": res.get("last_fix_err_m", 1e9) < 100.0,
        "FIFO overruns = 0": (res["fifo"]["overruns"] == 0
                              and res["producer_overruns"] == 0),
        "blocks pushed = blocks sent":
            res["fifo"]["pushed"] == res["blocks_sent"],
        "the run ends on the producer's end of stream":
            res["ended_on_end_of_stream"],
        "the client got channel and PVT records":
            st.get("channel_health", 0) > 0 and st.get("pvt", 0) > 0,
        "the client's mask took effect": (
            res["mask_sent_after_fix_at_ms"] is not None
            and len(res["mask_command_ok"]) == 1
            and not res["mask_prn_in_pool"]),
        "k1_launches > 0, K2 and K3 none": (res["k1_launches"] > 0
                                            and res["k2_launches"] == 0
                                            and res["k3_launches"] == 0),
        "no jax or gnsstpu module loaded": not refused,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"gps_l1_tcp_live_12ch checks failed: "
                             f"{failed} (modules: {refused[:5]})")


#: The custom MAX2769 front end's rate (SURVEY.md:527, BASELINE.md:11; the
#: CLI's default --fs), complex at IF 0 so that its 2.048 Msps image holds
#: the whole C/A band.
FS16 = 16.0e6
SIG16 = SignalConfig(if_freq=0.0, fs=FS16, complex_iq=True)


def write_i8_file(sig, sats, n_ms: int, seed: int, device, path: str,
                  scale: float = 20.0, piece_ms: int = 500) -> None:
    """n_ms of the port simulator's signal as an i8_iq file, made on the
    card in pieces."""
    sim = IFSimulator(sig, sats, noise_sigma=1.0, seed=seed, device=device)
    with open(path, "wb") as f:
        for ms0 in range(0, n_ms, piece_ms):
            x = sim.generate_tensor(min(piece_ms, n_ms - ms0), ms0)
            q = torch.clamp(torch.round(x * scale), -127, 127).to(
                torch.int8)
            q.cpu().numpy().reshape(-1).tofile(f)


def resample_apply_check(device, path: str, count: int) -> dict:
    """The polyphase apply at 16 -> 2.048 Msps on the card for `count`
    outputs of the i8_iq file at `path`: CUDA-event ms, peak device
    memory beyond what was allocated, and the largest error against a
    float64 numpy direct sum of the same window over the input's peak."""
    bank = rs.PolyphaseBank(*rs.rational_ratio(FS16, SIG.fs))
    base, w = bank.window(10_000, count)
    lo = int(base.min())
    x = FileSource(path, fmt="i8_iq").read(lo, int(base.max()) + bank.K
                                           - lo)
    xt = torch.as_tensor(x, device=device)
    rel = torch.as_tensor(base - lo, device=device)
    wt = torch.as_tensor(w, device=device)
    out = rs.apply_window(xt, rel, wt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    reps = 20 if count <= 4096 else 5
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        rs.apply_window(xt, rel, wt)
    e1.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - before
    idx = (base - lo)[:, None] + np.arange(bank.K)[None, :]
    ref = np.einsum("nk,nkc->nc", w.astype(np.float64),
                    x.astype(np.float64)[idx])
    err = float(np.max(np.abs(out.cpu().numpy() - ref)))
    return {"outputs": count, "K": bank.K, "ms": e0.elapsed_time(e1) / reps,
            "peak_mib": peak / 2**20,
            "max_abs_err_over_peak": err / float(np.abs(x).max())}


def k1_kernel_us(inputs, reps: int) -> float:
    """K1's mean device time per launch in us from a torch.profiler
    trace of `reps` launches: the kernel's own duration, whatever the
    host's pace of issuing them. A warm-up step of 20 launches runs with
    the tracer already on and is not recorded: a trace's first kernels
    can be lost while the tracer starts (a trace beside the resampler's
    stream once missed 2 of 200)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    args, kw = inputs
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "k1.json")
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            for n in (20, reps):
                for _ in range(n):
                    tk.track_chunk_fused(*args, **kw)
                torch.cuda.synchronize()
                prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    durs = [float(e["dur"]) for e in events
            if e.get("cat") == "kernel" and K1_GLOBAL in e.get("name", "")]
    if len(durs) != reps:
        raise AssertionError(f"profiler saw {len(durs)} of {reps} K1 "
                             "launches")
    return float(np.mean(durs))


def k1_beside_producer(device, path: str, reps: int = 1000) -> dict:
    """K1 per C=12 x 100-block launch alone, then while a
    FileStreamProducer resamples the 16 Msps file on its own stream into
    a FIFO nobody drains: the CUDA-event ms per launch on the default
    stream (which also counts the host's pace of issuing launches) and
    the kernel's device time from a profiler trace."""
    inputs = k1_inputs(12, 100, device)
    idle = kernel_times(inputs, tk.track_chunk_fused, None, reps)[0]
    idle_us = k1_kernel_us(inputs, 200)
    blk = SIG.samples_per_code
    fifo = native.RingFifo(depth=4096, block_bytes=blk * 8)
    prod = FileStreamProducer(path, fifo, blk, fmt="i8_iq", fs_in=FS16,
                              fs_out=SIG.fs, device=device)
    try:
        prod.start()
        deadline = time.monotonic() + 30.0
        while fifo.stats()["pushed"] < 20:
            if time.monotonic() > deadline:
                raise AssertionError("the producer pushed nothing")
            time.sleep(0.005)
        n0 = fifo.stats()["pushed"]
        busy = kernel_times(inputs, tk.track_chunk_fused, None, reps)[0]
        busy_us = k1_kernel_us(inputs, 200)
        n1 = fifo.stats()["pushed"]
    finally:
        prod.stop()
        fifo.close()
        prod.thread.join(timeout=30.0)
    return {"event_ms_alone": idle, "event_ms_beside_producer": busy,
            "kernel_us_alone": idle_us,
            "kernel_us_beside_producer": busy_us,
            "blocks_resampled_meanwhile": n1 - n0}


def gps_resampled_path(device, k1_ms: float, seconds: float = 8.0) -> dict:
    """gps_l1_16msps_resampled_12ch: the GPS sky at the custom front end's
    16 Msps complex, written as i8_iq to a temporary file; a
    FileStreamProducer resamples each 1 ms block to 2.048 Msps on the
    card (polyphase, its own CUDA stream) into the ring FIFO; a
    StreamSource feeds the manager at 12 channels (K1), 100 ms epochs x 4
    with prefetch, no navigator (8 s holds no ephemeris). Also the
    apply's time, memory and parity on the card, and the nearest mode
    exact."""
    sats16, prns, _, absent = gps_sky(SIG16)
    pool = prns + absent
    n_ms = int(round(seconds * 1000))
    epoch_ms, sync_every = 100, 4
    blk = SIG.samples_per_code
    blocks = history_blocks(SIG, epoch_ms, sync_every, None)
    cfg = gps_config(pool)
    # 10 ms fine Doppler (the CLI's default) hands over within a few Hz:
    # a coarse 250 Hz bin leaves slots the FLL pulls in only after
    # they fail confirmation, past this path's 8 s.
    cfg = dataclasses.replace(cfg, acq=dataclasses.replace(
        cfg.acq, fine_doppler_ms=10))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gps16.i8")
        t0 = time.perf_counter()
        write_i8_file(SIG16, sats16, n_ms + 300, 21, device, path)
        setup_s = time.perf_counter() - t0
        apply_1ms = resample_apply_check(device, path, blk)
        apply_100ms = resample_apply_check(device, path, 100 * blk)
        k1_beside = k1_beside_producer(device, path)
        near = ResampledSource(FileSource(path, fmt="i8_iq"), FS16, SIG.fs,
                               mode="nearest", device=device)
        idx = rs.nearest_indices(FS16, SIG.fs, 777, 5000)
        raw = FileSource(path, fmt="i8_iq").read(0, int(idx[-1]) + 1)
        nearest_exact = bool(np.array_equal(
            near.read(777, 5000), raw[idx]))
        fifo = native.RingFifo(depth=blocks, block_bytes=blk * 8)
        coll = _Collector()
        tlm = Telemetry(sink=None)
        tlm.subscribe(coll)
        prod = FileStreamProducer(path, fifo, blk, fmt="i8_iq", fs_in=FS16,
                                  fs_out=SIG.fs, resample_mode="polyphase",
                                  device=device)
        try:
            src = StreamSource(fifo, blk, history_blocks=blocks,
                               timeout_s=60.0)
            reset_counts()
            mgr = ChannelManager(
                src, cfg, device=device, telemetry=tlm, epoch_ms=epoch_ms,
                reacq_period_ms=1000, sync_every=sync_every,
                prn_pool=list(pool), prefetch=True, readback="compact",
                engine="fused")
            coll.enabled = True
            t0 = time.perf_counter()
            prod.start()
            recs = mgr.run(n_ms)
            if device.type == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            coll.enabled = False
        finally:
            prod.stop()
            fifo.close()
            prod.thread.join(timeout=30.0)
        if prod.thread.is_alive():
            raise AssertionError("file producer thread did not stop")
    launches = dict(tk.LAUNCHES)
    t_end = mgr.clock_ms * 1e-3
    sky = {}
    for s in sats16:
        slot = next((i for i, sl in enumerate(mgr.slots)
                     if sl.prn == s.prn and sl.state.value == "tracking"),
                    None)
        row = {"slot": slot}
        if slot is not None:
            h = mgr.prompt_stream(s.prn)
            row["doppler_err_hz"] = float(
                h["carr_doppler"][-epoch_ms:].mean()
                - (s.doppler_hz + s.doppler_rate
                   * (t_end - 0.5 * epoch_ms * 1e-3)))
            row["cn0_dbhz"] = float(recs[-1].cn0_dbhz[slot])
        sky[int(s.prn)] = row
    wall = t1 - t0
    return {
        "signal_s": seconds,
        "realtime_factor_overall": n_ms / 1000.0 / wall,
        "wall_s": wall,
        "signal_setup_s": setup_s,
        "taps_per_phase": prod.src.bank.K,
        "p_q": [prod.src.p, prod.src.q],
        "apply_1ms_block": apply_1ms,
        "apply_100ms_block": apply_100ms,
        "k1_ms_beside_producer": k1_beside,
        "nearest_exact": nearest_exact,
        "fifo": fifo.stats(),
        "engine": mgr.engine,
        "sky_prns": sorted(prns),
        "absent_prns": absent,
        "live_channels_at_end": int(sum(1 for p in recs[-1].prn if p)),
        "confirmed_prns": sorted({e["prn"] for e in coll.events
                                  if e["what"] == "channel_confirmed"}),
        "sky": sky,
        "k1_launches": launches["track_chunk_fused"],
        "k1_share_of_wall": launches["track_chunk_fused"] * k1_ms * 1e-3
        / wall,
        "k2_launches": launches["track_chunk_boc_fused"],
        "k3_launches": launches["track_chunk_dual_fused"],
        "summary_launches": sk.LAUNCHES["epoch_summary"],
        "decodes": up.DECODES["unpack"],
        "stage_wall_s": {k: round(v, 4) for k, v in
                         sorted(coll.stages.items())},
    }


#: The polyphase apply on the card against the float64 direct sum: f32
#: products summed over K = 250 taps, at most 1e-5 of the input's peak.
RESAMPLE_TOL = 1e-5


def gps_resampled_checks(res: dict) -> None:
    refused = refused_modules()
    live = [r for r in res["sky"].values() if r["slot"] is not None]
    checks = {
        "live >= 10 of 11": len(live) >= 10,
        "every live channel's Doppler within 5 Hz": all(
            abs(r["doppler_err_hz"]) < 5.0 for r in live),
        "no absent PRN confirmed":
            not set(res["confirmed_prns"]) & set(res["absent_prns"]),
        "apply parity": max(res["apply_1ms_block"]["max_abs_err_over_peak"],
                            res["apply_100ms_block"][
                                "max_abs_err_over_peak"]) <= RESAMPLE_TOL,
        "nearest exact": res["nearest_exact"],
        "K1's kernel time beside the producer within 20% of alone": (
            res["k1_ms_beside_producer"]["kernel_us_beside_producer"]
            <= 1.2 * res["k1_ms_beside_producer"]["kernel_us_alone"]),
        "k1_launches > 0, K2 and K3 none": (res["k1_launches"] > 0
                                            and res["k2_launches"] == 0
                                            and res["k3_launches"] == 0),
        "no jax or gnsstpu module loaded": not refused,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"gps_l1_16msps_resampled_12ch checks "
                             f"failed: {failed} (modules: {refused[:5]})")


#: K1's __global__ function in csrc/track_fused.cu, as a profiler trace
#: names its launches.
K1_GLOBAL = "track_fused_kernel"


def _banner_port(proc, tags: dict, timeout_s: float = 120.0) -> dict:
    """Ports from a subprocess's stderr banners ('... on tcp://H:PORT'),
    by key of `tags`."""
    ports = {}
    deadline = time.monotonic() + timeout_s
    lines = []
    while len(ports) < len(tags) and time.monotonic() < deadline:
        line = proc.stderr.readline()
        if not line:
            break
        lines.append(line)
        for key, tag in tags.items():
            if tag in line:
                ports[key] = int(line.split(tag)[1].split(":")[2]
                                 .split()[0])
    if len(ports) < len(tags):
        raise AssertionError(f"banners missing: {ports} in {lines[-20:]}")
    return ports


def cli_path(device, seconds: float = 6.0) -> dict:
    """The CLI on the card: `python -m gnsstpu_torch track --listen tcp:0
    --listen-fmt sm2 --station-port 0 --profile DIR --log LOG` (4
    channels, the main path's 500 ms epochs x 8 with prefetch, so its
    FIFO holds the whole signal while the receiver starts) on a 3-SV sky,
    this process sending the bytes to the banner's port at 8 x real time
    and `python -m gnsstpu_torch monitor tcp://127.0.0.1:PORT --follow`
    running alongside."""
    sats = [SatParams(prn=p, doppler_hz=d, code_phase_chips=cp,
                      cn0_dbhz=47.0)
            for p, d, cp in ((4, 1200.0, 100.5), (11, -2100.0, 600.25),
                             (23, 350.0, 901.75))]
    n_ms = int(round(seconds * 1000))
    sim = IFSimulator(SIG, sats, noise_sigma=1.0, seed=5, device=device)
    wire = up.pack(sim.generate(n_ms + 200), "sm2", 1.0).tobytes()
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        prof, log = os.path.join(tmp, "prof"), os.path.join(tmp, "tlm.jsonl")
        t0 = time.perf_counter()
        try:
            rx = subprocess.Popen(
                [sys.executable, "-m", "gnsstpu_torch", "track", "--device",
                 device.type, "--listen", "tcp:0", "--listen-fmt", "sm2",
                 "--station-port", "0",
                 "--profile", prof, "--log", log, "--fs", "2.048e6",
                 "--if-freq", "0", "--ms", str(n_ms), "--band", "6e3",
                 "--threshold", "2.4", "--channels", "4", "--epoch-ms",
                 "500", "--sync-every", "8", "--prefetch", "--readback",
                 "compact"], cwd=repo, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            procs.append(rx)
            ports = _banner_port(rx, {
                "listen": "listening for IF samples on",
                "station": "station server on"})
            mon = subprocess.Popen(
                [sys.executable, "-m", "gnsstpu_torch", "monitor",
                 f"tcp://127.0.0.1:{ports['station']}", "--follow",
                 "--interval", "0.2"], cwd=repo, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            procs.append(mon)
            time.sleep(1.0)
            _send_paced(ports["listen"], wire, 8.0 * len(wire) / (
                n_ms + 200) * 1000.0, 64 * 1024)
            rx_out, rx_err = rx.communicate(timeout=300)
            mon_out, mon_err = mon.communicate(timeout=60)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        trace = os.path.join(prof, "trace.json")
        text = ""
        if os.path.exists(trace):
            with open(trace) as f:
                text = f.read()
        n_tlm = 0
        if os.path.exists(log):
            with open(log) as f:
                n_tlm = sum(1 for _ in f)
    live = None
    if "live PRNs at end: " in rx_out:
        live = json.loads(rx_out.rsplit("live PRNs at end: ", 1)[1])
    events = json.loads(text)["traceEvents"] if text else []
    k1_events = [e for e in events if K1_GLOBAL in str(e.get("name", ""))]
    return {
        "wall_s": wall,
        "track_rc": rx.returncode,
        "monitor_rc": mon.returncode,
        "banner": "listen" in ports,
        "live_prns_at_end": live,
        "sky_prns": sorted(s.prn for s in sats),
        "monitor_board": " ch  prn  state" in mon_out,
        "monitor_closed": "-- receiver closed the link" in mon_out,
        "telemetry_lines": n_tlm,
        "trace_bytes": len(text),
        "trace_events": len(events),
        "trace_k1_events": len(k1_events),
        "trace_k1_device_us": sum(float(e.get("dur", 0.0))
                                  for e in k1_events
                                  if e.get("cat") == "kernel"),
        "track_stderr_tail": rx_err[-300:] if rx.returncode else "",
        "monitor_stderr_tail": mon_err[-300:] if mon.returncode else "",
    }


def cli_checks(res: dict) -> None:
    checks = {
        "track exits 0": res["track_rc"] == 0,
        "banner printed": res["banner"],
        "live PRNs at end name the sky":
            sorted(res["live_prns_at_end"] or []) == res["sky_prns"],
        "monitor renders a board and exits 0 on the close":
            res["monitor_rc"] == 0 and res["monitor_board"]
            and res["monitor_closed"],
        "the trace names K1's __global__": res["trace_k1_events"] > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"CLI checks failed: {failed}")


# ---------------------------------------------------------------------------
# The offline chain (phases 22-28): runtime.receiver.run_receiver, the
# chunked drivers track / track_boc / track_dual, the P-code tracker and
# the CLI's solve, each at the configuration of the reference test named.
# ---------------------------------------------------------------------------

#: tests/test_full_chain.py: GPS L1 C/A, 2.048 Msps complex, 6 SVs.
FC_TOW0_6S, FC_NMS = 44400, 24000
FC_CFG = ReceiverConfig(
    signal=SIG,
    acq=AcqConfig(doppler_band=12e3, coherent_ms=2, threshold=2.5),
    track=TrackConfig(dll_bw=1.0, pll_bw=25.0, fll_bw=250.0),
    nav=NavConfig(sol_period_ms=500, elevation_mask_deg=10.0,
                  use_tropo=False),
    n_channels=8, ms_to_process=FC_NMS)
#: examples/e2e_glonass_fix.py: GLONASS L1OF at 4.096 Msps (K1 at blkp
#: 4,098, as BSIG, tests/test_beidou.py:176-220's BeiDou front end).
OSIG4 = SignalConfig(signal="glonass_l1of", if_freq=0.0, fs=4.096e6,
                     code_freq=0.511e6, code_length=511, fdma_step=562.5e3,
                     complex_iq=True)
#: The kernels by wrapper name, as the offline phases print them.
OFFLINE_KERNEL = {"track_chunk_fused": "K1", "track_chunk_boc_fused": "K2",
                  "track_chunk_dual_fused": "K3"}


def offline_source(sig, sats, n_ms: int, seed: int, device
                   ) -> DeviceArraySource:
    """n_ms of the port simulator's signal on the card as f32 samples,
    made in 1 s pieces before the timed run; zeros past its end."""
    sim = IFSimulator(sig, sats, noise_sigma=1.0, seed=seed, device=device)
    x = torch.cat([sim.generate_tensor(min(1000, n_ms - ms0), ms0)
                   for ms0 in range(0, n_ms, 1000)])
    torch.cuda.synchronize()
    return DeviceArraySource(x)


class ReplaySource:
    """The reference tests' source, a SimSource over the simulator with
    the reference's own noise (IFSimulator(noise="jax"): jax.random's
    draws, keyed by seed and each lazily made piece's first ms, as the
    reference's SimSource makes them), so a phase tracks the very signal
    of the reference test it names. A first run through it records every
    read as a tensor on the card; replay() then serves the same reads
    again, so a timed second run meets no simulator and no upload."""

    def __init__(self, sig, sats, n_ms: int, seed: int, device):
        sim = IFSimulator(sig, sats, noise_sigma=1.0, seed=seed,
                          device=device, noise="jax")
        self.src = SimSource(sim, n_ms)
        self.device = device
        self.log = []
        self.at = None

    def read(self, start: int, count: int) -> torch.Tensor:
        if self.at is None:
            x = torch.as_tensor(self.src.read(start, count),
                                device=self.device)
            self.log.append((start, count, x))
            return x
        s0, n, x = self.log[self.at]
        if (s0, n) != (start, count):
            raise AssertionError(f"replayed read ({start}, {count}) is not "
                                 f"the recorded ({s0}, {n})")
        self.at += 1
        return x

    def replay(self) -> None:
        self.at = 0


def fix_errors(nav, recv) -> dict:
    """Valid epochs, 3D errors against recv and the mean speed of a
    NavSolutions (None when there is none)."""
    if nav is None or not np.any(nav.valid):
        return {"valid_epochs": 0}
    v = nav.valid
    err = np.linalg.norm(np.stack([nav.x[v], nav.y[v], nav.z[v]], 1)
                         - recv, axis=1)
    out = {"valid_epochs": int(v.sum()), "mean_3d_err_m": float(err.mean()),
           "max_3d_err_m": float(err.max()),
           "max_gdop": float(np.max(nav.dop[v, 0])),
           "mean_lat_deg": float(np.mean(nav.latitude[v])),
           "mean_lon_deg": float(np.mean(nav.longitude[v]))}
    if np.any(nav.vel_valid):
        vv = nav.vel_valid
        speed = np.linalg.norm(np.stack([nav.vx, nav.vy, nav.vz], 1)[vv],
                               axis=1)
        out.update(vel_epochs=int(vv.sum()),
                   mean_speed_mps=float(speed.mean()),
                   max_speed_mps=float(speed.max()))
    return out


def offline_run(device, src: ReplaySource, cfg, n_ms: int, kernel: str,
                k_ms: float, seconds: float) -> tuple:
    """run_receiver on the card over src (seconds of signal): a first run
    that records the simulator's reads (and warms up), then the timed
    run over the same reads. Returns its output and the run's record
    (realtime factor, the stage split, the kernel's launches and share
    of the wall, the modules refused)."""
    from gnsstpu_torch.runtime.receiver import run_receiver

    t0 = time.perf_counter()
    run_receiver(src, cfg, n_ms=n_ms, device=device)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    src.replay()
    reset_counts()
    t0 = time.perf_counter()
    out = run_receiver(src, cfg, n_ms=n_ms, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tk.LAUNCHES)
    rec = {"signal_s": seconds, "wall_s": wall,
           "realtime_factor": seconds / wall,
           "first_run_s": setup,
           "stage_s": {k: round(v, 4) for k, v in out.stage_s.items()},
           "channels": [c.prn for c in out.channels],
           "kernel": OFFLINE_KERNEL[kernel],
           "launches": launches[kernel],
           "other_kernel_launches": sum(v for k, v in launches.items()
                                        if k != kernel),
           "kernel_ms_per_launch": k_ms,
           "kernel_share_of_wall": launches[kernel] * k_ms * 1e-3 / wall,
           "ephemerides": sorted(out.ephs),
           "refused_modules": refused_modules()}
    return out, rec


def eph_mismatches(decoded: dict, truth: dict, fields) -> list:
    """(prn, field) pairs where a decoded ephemeris differs from the
    truth; a missing PRN counts as ('missing', prn)."""
    bad = [("missing", p) for p in truth if p not in decoded]
    for prn, dec in decoded.items():
        if prn in truth:
            bad += [(prn, f) for f in fields
                    if getattr(dec, f) != getattr(truth[prn], f)]
    return bad


def with_checks(rec: dict, checks: dict) -> dict:
    """rec with its 'checks' (name: passed): an offline phase's own and
    those every phase shares (its kernel launched and no other, no jax /
    gnsstpu module loaded)."""
    checks = dict(checks)
    checks["its kernel launched, no other"] = (
        rec["launches"] > 0 and rec["other_kernel_launches"] == 0)
    checks["no jax or gnsstpu module loaded"] = not rec["refused_modules"]
    rec["checks"] = checks
    return rec


def raise_failed(tag: str, rec: dict) -> None:
    """Raises when a check of a printed phase record failed."""
    failed = [k for k, ok in rec["checks"].items() if not ok]
    if failed:
        raise AssertionError(f"{tag} checks failed: {failed}")


def gps_solve_ephs() -> tuple:
    """tests/test_full_chain.py::visible_ephs(6): bench_constellation's 24
    orbits, the 6 highest, highest first. Returns ({prn: ephemeris},
    receiver ECEF)."""
    from gnsstpu_torch.nav.orbits import satpos
    from gnsstpu_torch.nav.types import Ephemeris
    from gnsstpu_torch.nav import geodesy

    base = dict(
        t_oc=266400.0, a_f0=2.45e-4, a_f1=-3.2e-12, a_f2=0.0,
        T_GD=-4.656e-9, sqrtA=5153.712, e=0.0123456, M_0=1.23456,
        deltan=4.2e-9, omega=-1.87654, omega_0=-2.0312, omegaDot=-8.1e-9,
        i_0=0.96123, iDot=4.0e-10, t_oe=266400.0, C_uc=-6.7e-7,
        C_us=8.1e-6, C_rc=221.5625, C_rs=-12.8125, C_ic=-7.45e-8,
        C_is=1.12e-7, valid=True)
    recv = np.array([3427947.0, 603774.0, 5326967.0])
    ephs = []
    for k in range(24):
        d = dict(base)
        d["M_0"] = (base["M_0"] + 2.1 * k) % (2 * np.pi) - np.pi
        d["omega_0"] = (base["omega_0"] + 1.1 * k) % (2 * np.pi) - np.pi
        d["i_0"] = 0.93 + 0.03 * (k % 3)
        ephs.append(Ephemeris(**d))
    pos, _ = satpos(FC_TOW0_6S * 6.0, ephs)
    _, el, _ = geodesy.topocent(recv, pos - recv)
    return {int(k) + 1: ephs[k] for k in np.argsort(-el)[:6]}, recv


def gps_solve_sky() -> tuple:
    """tests/test_full_chain.py's sky: visible_ephs(6) through
    build_scenario at 47 dB-Hz. Returns (sats, {prn: ephemeris},
    receiver ECEF)."""
    from gnsstpu_torch.sim.scenario import build_scenario

    chosen, recv = gps_solve_ephs()
    sats = build_scenario(SIG, chosen, recv, FC_TOW0_6S,
                          duration_s=FC_NMS / 1000.0, cn0_dbhz=47.0)
    return sats, chosen, recv


def solve_setup(name: str) -> dict:
    """The configuration of an offline phase (22-25) as its reference test
    sets it: sig, sats, the ReceiverConfig cfg, n_ms (code periods
    tracked), src_ms (the milliseconds its SimSource holds), the seed, the
    receiver position recv, the truth {prn: ephemeris} and the kernel."""
    nav = NavConfig(sol_period_ms=500, elevation_mask_deg=10.0,
                    use_tropo=False)
    if name == "gps_l1_solve_8ch":
        sats, truth, recv = gps_solve_sky()
        return dict(sig=SIG, sats=sats, cfg=FC_CFG, n_ms=FC_NMS,
                    src_ms=FC_NMS + 50, seed=21, recv=recv, truth=truth,
                    kernel="track_chunk_fused")
    if name == "galileo_e1b_solve_5ch":
        n_per = 3250
        sats, _, recv, truth = galileo_constellation(
            GSIG, 5, duration_s=n_per * GSIG.code_period_s, cn0_dbhz=48.0)
        cfg = ReceiverConfig(
            signal=GSIG,
            acq=AcqConfig(doppler_band=9e3, coherent_ms=1, threshold=2.2,
                          doppler_step=75.0, prn_list=tuple(sorted(truth))),
            track=GTRK, nav=nav, n_channels=5, ms_to_process=n_per)
        return dict(sig=GSIG, sats=sats, cfg=cfg, n_ms=n_per,
                    src_ms=int((n_per + 8) * GSIG.code_period_ms), seed=23,
                    recv=recv, truth=truth, kernel="track_chunk_boc_fused")
    if name == "beidou_b1i_solve_6ch":
        n_ms = 20600
        sats, _, recv, truth = beidou_constellation(
            BSIG, 5, duration_s=n_ms / 1000.0, cn0_dbhz=48.0)
        cfg = ReceiverConfig(
            signal=BSIG,
            acq=AcqConfig(doppler_band=12e3, coherent_ms=1, threshold=2.0,
                          doppler_step=125.0),
            track=BTRK, nav=nav, n_channels=6, ms_to_process=n_ms)
        return dict(sig=BSIG, sats=sats, cfg=cfg, n_ms=n_ms,
                    src_ms=n_ms + 60, seed=17, recv=recv, truth=truth,
                    kernel="track_chunk_fused")
    if name == "glonass_l1of_solve_6ch":
        n_ms = 10000
        gephs = make_glonass_constellation(GFIX_RECV, GFIX_TB, n=6)
        sats, truth = build_scenario_glonass(
            OSIG4, gephs, GFIX_RECV, GFIX_T0, duration_s=n_ms / 1000.0,
            cn0_dbhz=48.0, n_strings=4)
        cfg = ReceiverConfig(
            signal=OSIG4,
            acq=AcqConfig(doppler_band=14e3, coherent_ms=2, threshold=2.5),
            track=OTRK, nav=nav, n_channels=6, ms_to_process=n_ms)
        return dict(sig=OSIG4, sats=sats, cfg=cfg, n_ms=n_ms,
                    src_ms=n_ms + 60, seed=31, recv=GFIX_RECV, truth=truth,
                    kernel="track_chunk_fused")
    raise ValueError(f"no offline configuration {name!r}")


#: The offline phases' configurations, in phase order (22-25).
SOLVE_PHASES = ("gps_l1_solve_8ch", "galileo_e1b_solve_5ch",
                "beidou_b1i_solve_6ch", "glonass_l1of_solve_6ch")


def solve_run(device, name: str, k_ms: float) -> tuple:
    """An offline phase's run on the card over its reference test's own
    signal: (run_receiver's output, the run's record with the fix's
    errors, the setup)."""
    st = solve_setup(name)
    src = ReplaySource(st["sig"], st["sats"], st["src_ms"], st["seed"],
                       device)
    seconds = st["n_ms"] * st["sig"].code_period_s
    out, rec = offline_run(device, src, st["cfg"], st["n_ms"], st["kernel"],
                           k_ms, seconds)
    rec.update(sky_prns=sorted(st["truth"]), **fix_errors(out.nav,
                                                          st["recv"]))
    return out, rec, st


def gps_solve_path(device, k1: dict) -> dict:
    """gps_l1_solve_8ch: tests/test_full_chain.py:32-69 on the card."""
    out, rec, st = solve_run(device, "gps_l1_solve_8ch", k1["ms"])
    lsb = 2.0 ** -19
    bad = [("missing", p) for p in st["truth"] if p not in out.ephs]
    for prn, dec in out.ephs.items():
        t = st["truth"].get(prn)
        if t is None or dec.IODC != t.IODC or dec.sqrtA != round(
                t.sqrtA / lsb) * lsb:
            bad.append((prn, "IODC/sqrtA"))
    rec.update(k1_shape=k1, eph_mismatches=bad,
               tows=sorted(set(out.tows.values())))
    return with_checks(rec, {
        "every sky SV has a channel":
            set(rec["sky_prns"]) <= set(rec["channels"]),
        "every ephemeris as the truth (IODC, sqrtA)":
            not rec["eph_mismatches"],
        "TOW exact": rec["tows"] == [FC_TOW0_6S * 6.0],
        ">= 10 valid epochs": rec["valid_epochs"] >= 10,
        "mean 3D < 20 m, max < 60 m": rec["valid_epochs"] > 0
        and rec["mean_3d_err_m"] < 20.0 and rec["max_3d_err_m"] < 60.0,
        "GDOP < 25": rec["valid_epochs"] > 0 and rec["max_gdop"] < 25.0,
        "mean speed < 2 m/s, max < 8": rec.get("vel_epochs", 0) >= 10
        and rec["mean_speed_mps"] < 2.0 and rec["max_speed_mps"] < 8.0,
    })


def galileo_solve_path(device, k2_ms: float) -> dict:
    """galileo_e1b_solve_5ch: tests/test_galileo.py:199-242 on the card
    (5 channels, 3,250 periods of 4 ms, 48 dB-Hz)."""
    out, rec, st = solve_run(device, "galileo_e1b_solve_5ch", k2_ms)
    rec.update(eph_mismatches=eph_mismatches(
        out.ephs, st["truth"], ("sqrtA", "e", "M_0", "omega_0", "i_0",
                                "t_oe", "a_f0", "a_f1", "deltan", "omega",
                                "IODnav")))
    return with_checks(rec, {
        "every ephemeris as the truth": not rec["eph_mismatches"]
        and rec["ephemerides"] == rec["sky_prns"],
        ">= 8 valid epochs": rec["valid_epochs"] >= 8,
        "mean 3D < 25 m, max < 80 m": rec["valid_epochs"] > 0
        and rec["mean_3d_err_m"] < 25.0 and rec["max_3d_err_m"] < 80.0,
    })


def beidou_solve_path(device, k1: dict) -> dict:
    """beidou_b1i_solve_6ch: tests/test_beidou.py:176-220 on the card
    (beidou_constellation's 5 highest SVs, 4.096 Msps, 6 channels,
    20,600 ms, 48 dB-Hz; K1 at blkp 4,098 with the 'atan' FLL)."""
    out, rec, st = solve_run(device, "beidou_b1i_solve_6ch", k1["ms"])
    rec.update(k1_shape=k1, eph_mismatches=eph_mismatches(
        out.ephs, st["truth"], ("sqrtA", "e", "M_0", "omega_0", "i_0",
                                "t_oe", "a0", "a1", "deltan", "omega")))
    return with_checks(rec, {
        "every D1 ephemeris as the truth": not rec["eph_mismatches"]
        and rec["ephemerides"] == rec["sky_prns"],
        ">= 10 valid epochs": rec["valid_epochs"] >= 10,
        "mean 3D < 25 m, max < 80 m": rec["valid_epochs"] > 0
        and rec["mean_3d_err_m"] < 25.0 and rec["max_3d_err_m"] < 80.0,
    })


def glonass_solve_path(device, k1: dict) -> dict:
    """glonass_l1of_solve_6ch: examples/e2e_glonass_fix.py on the card (6
    SVs on their frequency channels, 4.096 Msps, FDMA acquisition, 10 s;
    K1 at blkp 4,098, each channel's FDMA carrier base)."""
    _, rec, _ = solve_run(device, "glonass_l1of_solve_6ch", k1["ms"])
    rec.update(k1_shape=k1)
    return with_checks(rec, {
        "a navigation solution": rec["valid_epochs"] > 0,
        "mean 3D < 25 m": rec["valid_epochs"] > 0
        and rec["mean_3d_err_m"] < 25.0,
    })


def l3_dual_path(device, k3_ms: float) -> dict:
    """glonass_l3oc_track_dual_8ch: track_dual over phase 13's sky (8
    satellites, pilot + data, 24 Msps, 9 s; the same seeds), its channels
    from the port's acquisition (the pool with 2 absent satellites); K3 at
    C = the channels acquired x 256 blocks."""
    from gnsstpu_torch.runtime.receiver import allocate_channels
    from gnsstpu_torch.tracking.dual import track_dual

    n_ms = 9000
    prns = [3, 7, 11, 14, 18, 22, 26, 30]
    absent = [5, 9]
    rng = np.random.default_rng(31)
    dopp = rng.permutation(np.linspace(-3600.0, 3600.0, len(prns)))
    rates = rng.uniform(-0.55, 0.55, len(prns))
    cps = (np.arange(len(prns)) * 10230.0 / len(prns)
           + rng.uniform(0.0, 1000.0, len(prns)))
    sats, bits = l3_sky(prns, dopp, rates, cps, n_ms + 20, seed=32)
    t0 = time.perf_counter()
    src = offline_source(LSIG, sats, n_ms + 20, 33, device)
    setup = time.perf_counter() - t0
    acq = AcqConfig(doppler_band=8e3, coherent_ms=1, threshold=2.5,
                    doppler_step=250.0, prn_list=tuple(prns + absent))
    reset_counts()
    t0 = time.perf_counter()
    x = src.read(0, search.acq_samples_needed(LSIG, acq)).cpu().numpy()
    res = search.acquire(x, LSIG, acq, device=device)
    chans = allocate_channels(res, 8, sd=get_signal(LSIG.signal),
                              if_freq=LSIG.if_freq)
    t1 = time.perf_counter()
    tr = track_dual(src, chans, LSIG, LTRK, n_ms, device=device)
    t2 = time.perf_counter()
    launches = dict(tk.LAUNCHES)
    sky = {}
    t_mid = (n_ms - 250) * 1e-3
    for c, ch in enumerate(chans):
        k = prns.index(ch.prn) if ch.prn in prns else None
        row = {}
        if k is not None:
            row["doppler_err_hz"] = float(
                tr.carr_freq[c, -500:].mean() - LSIG.if_freq
                - (dopp[k] + rates[k] * t_mid))
            sync, ok = l3_bits_recovered(
                {"i_p": tr.i_p[c], "q_p2": tr.q_p2[c]}, bits[ch.prn])
            row.update(overlay_found=bool(sync.found),
                       overlay_quality=float(sync.quality), bits_exact=ok)
        sky[ch.prn] = row
    wall = t2 - t0
    rec = {"signal_s": n_ms / 1000.0, "wall_s": wall,
           "realtime_factor": n_ms / 1000.0 / wall,
           "stage_s": {"acquire": round(t1 - t0, 4),
                       "track": round(t2 - t1, 4)},
           "signal_setup_s": setup,
           "channels": [c.prn for c in chans], "sky_prns": prns,
           "kernel": "K3", "launches": launches["track_chunk_dual_fused"],
           "other_kernel_launches": (launches["track_chunk_fused"]
                                     + launches["track_chunk_boc_fused"]),
           "kernel_ms_per_launch": k3_ms,
           "kernel_share_of_wall": launches["track_chunk_dual_fused"]
           * k3_ms * 1e-3 / wall,
           "sky": sky, "refused_modules": refused_modules()}
    rows = [sky.get(p, {}) for p in prns]
    return with_checks(rec, {
        "every sky satellite has a channel": set(prns) <= set(
            rec["channels"]),
        "|Doppler - truth| < 5 Hz": all(
            abs(r.get("doppler_err_hz", 1e9)) < 5.0 for r in rows),
        "NH sync quality >= 0.9": all(
            r.get("overlay_found") and r["overlay_quality"] >= 0.9
            for r in rows),
        "24 data bits exact": all(r.get("bits_exact") for r in rows),
    })


def pcode_path(device) -> dict:
    """tests/test_glonass.py:319-366's P-code closed loop on the card: the
    aperiodic 5.11 Mcps code at 12 Msps, 870 Hz Doppler on frequency
    channel -1, handed over 15 Hz off; 150 blocks of plain torch ops (no
    hand kernel: the reference's tracker is a lax.scan, no Pallas)."""
    from gnsstpu_torch.signals.glonass import generate_p_code
    from gnsstpu_torch.tracking import pcode

    fs, n_ms, dopp = 12.0e6, 150, 870.0
    f_carr = 1.246e9 - 437.5e3
    aid = f_carr / pcode.P_CODE_FREQ
    chip0 = 3 * pcode.BLOCK_CHIPS + 1234
    code = generate_p_code((n_ms + 6) * pcode.BLOCK_CHIPS + chip0).astype(
        np.float64)
    n = int(fs * (n_ms + 4) * 1e-3)
    t = np.arange(n) / fs
    idx = np.floor(chip0 + 0.08 + pcode.P_CODE_FREQ
                   * (1.0 + dopp / f_carr) * t).astype(np.int64)
    rng = np.random.default_rng(9)
    amp = 1.2
    phase = 2 * np.pi * dopp * t + 0.6
    chunk = np.stack([amp * code[idx] * np.cos(phase) + rng.normal(0, 1, n),
                      amp * code[idx] * np.sin(phase) + rng.normal(0, 1, n)],
                     1).astype(np.float32)
    tracker = pcode.make_pcode_tracker(
        fs, 0.0, TrackConfig(dll_bw=5.0, el_spacing=0.3), n_blocks=n_ms,
        aid_div=aid)
    st = pcode.PState.init(sample_pos=int(np.searchsorted(idx, chip0)),
                           chip_off=chip0, doppler_hz=dopp - 15.0,
                           aid_div=aid, device=device)
    chunk_d = torch.as_tensor(chunk, device=device)
    code_d = torch.as_tensor(code.astype(np.float32), device=device)
    tracker(chunk_d, code_d, st)                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, outs = tracker(chunk_d, code_d, st)
    ip = outs["ip"].cpu().numpy()
    wall = time.perf_counter() - t0
    dopp_out = outs["carr_doppler"].cpu().numpy()
    code_err = outs["code_err"].cpu().numpy()
    rec = {"blocks": n_ms, "wall_s": wall,
           "realtime_factor": n_ms * 1e-3 / wall,
           "device": str(outs["ip"].device),
           "prompt_power": float(np.abs(ip[-40:]).mean()),
           "prompt_floor": 0.5 * amp * fs / 1000,
           "doppler_err_hz": float(np.mean(dopp_out[-40:]) - dopp),
           "code_err_mean_abs": float(np.abs(code_err[-40:]).mean())}
    checks = {
        "on the card": rec["device"].startswith("cuda"),
        "prompt converged": rec["prompt_power"] > rec["prompt_floor"],
        "|Doppler - truth| < 2 Hz": abs(rec["doppler_err_hz"]) < 2.0,
        "code error < 0.04": rec["code_err_mean_abs"] < 0.04,
        "no jax or gnsstpu module loaded": not refused_modules(),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"pcode checks failed: {failed} {rec}")
    return rec


def write_solve_file(device, path: str) -> None:
    """Phase 22's signal as an i8_iq file (phases 28 and 34 read it)."""
    write_i8_file(SIG, gps_solve_sky()[0], FC_NMS + 50, 21, device, path)


def cli_solve_path(device, path: str) -> dict:
    """`python -m gnsstpu_torch solve FILE --fs 2.048e6 --if-freq 0
    --format i8_iq --ms 24000 --channels 8 --log LOG` on phase 22's
    signal written as an i8_iq file (write_solve_file), in a
    subprocess."""
    from gnsstpu_torch.nav import geodesy

    _, _, recv = gps_solve_sky()
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    lat, lon, _ = geodesy.cart2geo(*recv, 5)
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "pvt.log")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gnsstpu_torch", "solve", path, "--fs",
             "2.048e6", "--if-freq", "0", "--format", "i8_iq", "--ms",
             str(FC_NMS), "--channels", "8", "--log", log, "--device",
             device.type], cwd=repo, env=env, capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
        n_pvt = 0
        if os.path.exists(log):
            with open(log) as f:
                n_pvt = sum(json.loads(ln).get("type") == "pvt" for ln in f
                            if ln.strip())
    fix = None
    for ln in proc.stdout.splitlines():
        if ln.startswith("{"):
            fix = json.loads(ln)
    rec = {"rc": proc.returncode, "wall_s": wall, "pvt_records": n_pvt,
           "stdout": proc.stdout.splitlines()[:3],
           "fix": fix, "truth_lat_lon": [float(lat), float(lon)],
           "stderr_tail": proc.stderr[-300:] if proc.returncode else ""}
    checks = {
        "solve exits 0": proc.returncode == 0,
        "lat / lon within 1e-3 deg": fix is not None
        and abs(fix["lat_deg"] - lat) < 1e-3
        and abs(fix["lon_deg"] - lon) < 1e-3,
        "the log holds PVT records": n_pvt > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"CLI solve checks failed: {failed} {rec}")
    return rec


# --- the mesh (phases 29-34) -----------------------------------------------

def checked(rec: dict, checks: dict) -> dict:
    """rec with its 'checks' (name: passed), for raise_failed."""
    rec["checks"] = checks
    return rec


def quiet_mesh(axes) -> tuple:
    """(make_mesh(axes), its RuntimeWarning's text or None): with fewer
    cards than shards the shards share the cards, and make_mesh says so."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mesh = make_mesh(axes)
    return mesh, (str(w[0].message) if w else None)


def gps_mesh_path(device, src, base: dict, base_snap: dict) -> dict:
    """Phase 5's configuration and signal through
    ChannelManager(mesh=make_mesh([("channel", 2)])), held bit-identical
    to phase 5's unsharded run."""
    mesh, warned = quiet_mesh([("channel", 2)])
    res, _, snap = gps_main_path(device, src=src, mesh=mesh)
    res["mesh"] = repr(mesh)
    res["mesh_warning"] = warned
    res["mismatches_vs_phase_5"] = snapshot_mismatches(base_snap, snap)
    res["records_compared"] = len(snap["records"])
    res["streams_compared"] = sorted(int(p) for p in snap["streams"])
    want = [{"device": str(d), "rows": GPS_CHANNELS // 2}
            for d in mesh.axis_devices("channel")]
    checks = {
        "records and prompt streams bit-identical to phase 5":
            not res["mismatches_vs_phase_5"] and res["records_compared"] > 0,
        "live_channels_at_end >= 10": res["live_channels_at_end"] >= 10,
        "ephemerides_decoded >= 8": res["ephemerides_decoded"] >= 8,
        "pvt_solutions >= 10": res["pvt_solutions"] >= 10,
        "last_fix_err_m < 100": res.get("last_fix_err_m", 1e9) < 100.0,
        "K1 launched twice per epoch":
            res["k1_launches"] == 2 * base["k1_launches"] > 0,
        "summary launched once per epoch":
            res["summary_launches"] == base["summary_launches"] > 0,
        "state on the mesh": res["state_parts"] == want,
        "no jax or gnsstpu module loaded": not refused_modules(),
    }
    return checked(res, checks)


def summary_path(device, launches: int = 400) -> dict:
    """The epoch summary kernel at the GPS main path's shape: K1's out of
    one C=12 x 500 launch (strided lanes), 8 epoch slots of a compact
    readback. Against its plain version on the same tensors: the stream
    bytes equal, the stats within SUMMARY_TOL, a second fill
    bit-identical. Times (CUDA events, each run's launches queued behind
    a spin so the card runs them back to back): us per kernel launch and
    per epoch of the plain version, beside the bound (bytes). The locked
    lane is held equal wherever the plain C/N0 and PLL lock lie further
    than SUMMARY_TOL from cn0_drop and PLL_MIN."""
    args, kw = k1_inputs(12, 500, device)
    out = tk.track_chunk_fused(*args, **kw)[0]
    obs = EpochObs(
        ip=out[:, :, tk.O_IP], qp=out[:, :, tk.O_QP], ie=out[:, :, tk.O_IE],
        qe=out[:, :, tk.O_QE], il=out[:, :, tk.O_IL], ql=out[:, :, tk.O_QL],
        rem=out[:, :, tk.O_REM],
        blksize=out[:, :, tk.O_BLKSIZE].to(torch.int32),
        dopp=out[:, :, tk.O_CARR_DOPPLER])
    E, C, K = 500, 12, GPS_SYNC
    skw = dict(m=20, t_int_s=SIG.code_period_s, cn0_drop_dbhz=32.0,
               spc=int(SIG.samples_per_code))
    bufs = {}
    for run in ("kernel", "plain", "repeat"):
        (b,) = sk.new_readback(K, E, C, dual=False, compact=True,
                               device=device)
        for j in range(K):
            if run == "plain":
                sk.fill_plain(obs, [b], j, **skw)
            else:
                sk.epoch_summary(obs, [b], j, **skw)
        bufs[run] = b
    torch.cuda.synchronize()
    n_st = K * C * 16
    if not torch.equal(bufs["kernel"][:-n_st], bufs["plain"][:-n_st]):
        raise AssertionError("summary: stream lanes differ from the plain "
                             "version")
    if not torch.equal(bufs["kernel"], bufs["repeat"]):
        raise AssertionError("summary: two fills differ")
    st = {r: sk.compact_views(bufs[r], K, E, C, False)[4].cpu().numpy()
          for r in ("kernel", "plain")}
    dev = {}
    for i, (name, tol) in enumerate(SUMMARY_TOL.items()):
        dev[name] = float(np.max(np.abs(st["kernel"][..., i]
                                        - st["plain"][..., i])))
        if dev[name] > tol:
            raise AssertionError(f"summary: {name} off by {dev[name]}")
    want = st["plain"]
    away = ((np.abs(want[..., 0] - skw["cn0_drop_dbhz"])
             > SUMMARY_TOL["cn0_dbhz"])
            & (np.abs(want[..., 1] - sk.PLL_MIN) > SUMMARY_TOL["pll_lock"]))
    locked_off = int(np.sum(st["kernel"][..., 3][away] != want[..., 3][away]))
    if not away.any() or locked_off:
        raise AssertionError(f"summary: locked differs in {locked_off} of "
                             f"{int(away.sum())} channel epochs away from "
                             "the thresholds")
    (b,) = sk.new_readback(K, E, C, dual=False, compact=True, device=device)

    def kernel_run():
        for j in range(launches):
            sk.epoch_summary(obs, [b], j % K, **skw)

    def plain_run():
        for j in range(K):
            sk.fill_plain(obs, [b], j, **skw)

    kernel_run()
    plain_run()
    us = 1e6 * _timed_s(kernel_run, device) / launches
    plain_us = 1e6 * _timed_s(plain_run, device) / K
    n_bytes = E * C * (9 * 4 + 12) + C * 16
    b_ms, b_by = bound(n_bytes, 0.0)
    return {"us": us, "plain_us": plain_us, "bound_us": 1e3 * b_ms,
            "bound_by": b_by, "bytes": n_bytes, "stats_max_abs": dev,
            "locked_compared": int(away.sum()),
            "locked_plain_true": int(want[..., 3][away].sum()),
            **sk.summary_info()}


#: Phase 42's decodes: (tag, format, bytes). The sm2 bytes of one
#: superepoch in each benchmark cell (GPS L1 C/A: 4 s at 2.048 Msps;
#: GLONASS L3OC: 1 s at 24 Msps), then the other formats on the L3OC
#: chunk's bytes.
DECODE_CASES = (("gps_l1ca_4s", "sm2", 4_096_000),
                ("glonass_l3oc_1s", "sm2", 12_000_000),
                ("iq8_12MB", "iq8", 12_000_000),
                ("iq4_12MB", "iq4", 12_000_000),
                ("iq1_12MB", "iq1", 12_000_000))


def wire_decode_path(device, reps: int = 20) -> dict:
    """The wire decode (ops/unpack.py unpack: the int32 index cast and
    the gather from the format's 256-row table) for each DECODE_CASES
    entry: the card's decode bit-identical to the CPU's; ms per decode
    (CUDA events, reps decodes queued behind a spin) beside its bound
    (each byte read once, its f32 samples written once, at 3.35 TB/s);
    for sm2 also bit-identical to, and timed beside, the reference
    arithmetic the table replaced (_decode_arith) on the same bytes."""
    out = {}
    for tag, fmt, n in DECODE_CASES:
        host = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
        packed = torch.from_numpy(host).to(device)
        got = up.unpack(packed, fmt).view(torch.int32)
        want = torch.from_numpy(up.unpack_np(host, fmt)).view(torch.int32)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"wire decode {tag}: card differs from "
                                 "the CPU")
        runs = {"ms": lambda: up.unpack(packed, fmt)}
        if fmt == "sm2":
            arith = up._decode_arith(packed.to(torch.int32), fmt)
            if not torch.equal(got, arith.view(torch.int32)):
                raise AssertionError(f"wire decode {tag}: table differs "
                                     "from the arithmetic")
            runs["arith_ms"] = lambda: up._decode_arith(
                packed.to(torch.int32), fmt)
            del arith
        del got
        b_ms, b_by = bound(n * (1 + 8 * up.samples_per_byte(fmt)), 0.0)
        rec = {"format": fmt, "bytes": n, "bound_ms": b_ms,
               "bound_by": b_by}
        for key, fn in runs.items():

            def run():
                for _ in range(reps):
                    fn()

            run()
            rec[key] = 1e3 * _timed_s(run, device) / reps
        rec["ms_over_bound"] = rec["ms"] / b_ms
        out[tag] = rec
    return out


def cuda_ms(fn, reps: int = 20) -> float:
    """ms per call of fn() (CUDA events, after a warm-up call)."""
    fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def sharded_k1_path(device, C: int = 48, n_blocks: int = 500,
                    n_shards: int = 4) -> dict:
    """K1 at C x n_blocks split n_shards ways over make_mesh([("channel",
    n_shards)]), each shard launching on its own stream, against one
    launch at the whole width: outputs and state bit-identical, and ms
    per step of each (CUDA events)."""
    chunk, tab, consts, state0 = k1_track_inputs(C, n_blocks, device)
    single = tfused.make_fused_tracker(SIG, TRK, n_blocks=n_blocks)
    mesh, warned = quiet_mesh([("channel", n_shards)])
    st_s, tab_s, consts_s, chunk_s = shard_fused_inputs(
        state0, tab, consts, chunk, mesh)
    sharded = make_sharded_fused_tracker(SIG, TRK, mesh=mesh,
                                         n_blocks=n_blocks)
    before = tk.LAUNCHES["track_chunk_fused"]
    s1, o1 = single(chunk, tab, consts, state0)
    s4, o4 = sharded(chunk_s, tab_s, consts_s, st_s)
    torch.cuda.synchronize()
    launches = tk.LAUNCHES["track_chunk_fused"] - before
    identical = all(torch.equal(a, b) for a, b in zip(
        tree_leaves((o1, s1)), tree_leaves((o4, s4.gather()))))
    res = {"C": C, "n_blocks": n_blocks, "shards": n_shards,
           "mesh": repr(mesh), "mesh_warning": warned,
           "launches_single_and_sharded": launches,
           "single_launch_ms": cuda_ms(
               lambda: single(chunk, tab, consts, state0)),
           "sharded_step_ms": cuda_ms(
               lambda: sharded(chunk_s, tab_s, consts_s, st_s))}
    # The launches alone, their inputs packed once: on the shards' own
    # streams (do their CTAs run together?) and one after another on one.
    kw = tfused.kernel_kwargs(SIG, TRK, n_blocks=n_blocks)
    args = [tfused.kernel_inputs(chunk, tab_s.parts[i],
                                 tuple(c.parts[i] for c in consts_s),
                                 st_s.parts[i]) for i in range(n_shards)]
    streams = [torch.cuda.Stream(device=device) for _ in range(n_shards)]

    def on_streams():
        main = torch.cuda.current_stream(device)
        for a, st in zip(args, streams):
            st.wait_stream(main)
            with torch.cuda.stream(st):
                tk.track_chunk_fused(*a, **kw)
        for st in streams:
            main.wait_stream(st)

    def in_turn():
        for a in args:
            tk.track_chunk_fused(*a, **kw)

    res["launches_alone_own_streams_ms"] = cuda_ms(on_streams)
    res["launches_alone_one_stream_ms"] = cuda_ms(in_turn)
    # The host's time to enqueue one sharded step (no wait for the card).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        sharded(chunk_s, tab_s, consts_s, st_s)
    res["sharded_step_enqueue_ms"] = 1e3 * (time.perf_counter() - t0) / 20
    torch.cuda.synchronize()
    checks = {"outputs and state bit-identical to one launch": identical,
              f"{n_shards} launches beside the single one":
                  launches == 1 + n_shards}
    return checked(res, checks)


#: Phase 31's search: the main path's two 2 ms windows, 32 PRNs x the
#: 29 Doppler bins of a 7 kHz band at 250 Hz padded to 32, 2,048 lags.
SEARCH_ACQ = AcqConfig(doppler_band=7e3, coherent_ms=2, threshold=2.4)


def sharded_search_path(device) -> dict:
    """The cold search on a channel=2 x doppler=2 mesh against the
    unsharded cube: the same code_phase and doppler_bin, the metric
    within rtol 1e-5; ms (CUDA events) and peak device memory of each."""
    spc = SIG.samples_per_code
    sats = [SatParams(prn=p, doppler_hz=d, code_phase_chips=cp,
                      cn0_dbhz=46.0)
            for p, d, cp in ((3, 1250.0, 100.3), (11, -2750.0, 611.0),
                             (23, 500.0, 877.6))]
    x = IFSimulator(SIG, sats, noise_sigma=1.0, seed=7,
                    device=device).generate_tensor(8)
    blocks = search.stack_windows(x, spc, SEARCH_ACQ)
    fd = search.code_fd_tensor(SIG, SEARCH_ACQ, device)
    step = SEARCH_ACQ.doppler_bin_step()
    d29 = fft_acquire.doppler_grid(0.0, SEARCH_ACQ.doppler_band, step)
    dopp = torch.as_tensor(np.concatenate(
        [d29, d29[-1] + step * np.arange(1, 4)]), dtype=torch.float32,
        device=device)
    mesh, warned = quiet_mesh([("channel", 2), ("doppler", 2)])
    shards = shard_acquisition_inputs(blocks, fd, dopp, mesh)
    res = {"bins": [len(d29), int(dopp.shape[0])], "prns": fd.shape[0],
           "lags": spc, "mesh": repr(mesh), "mesh_warning": warned}
    cubes = {}
    for tag, call in (
            ("unsharded", lambda: fft_acquire.acquire_cube(
                blocks, fd, dopp, SIG.fs, spc)),
            ("sharded", lambda: fft_acquire.acquire_cube(
                shards, None, None, SIG.fs, spc))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        cubes[tag] = call()
        torch.cuda.synchronize()
        res[f"{tag}_peak_mb"] = (torch.cuda.max_memory_allocated(device)
                                 - base) / 2 ** 20
        res[f"{tag}_ms"] = cuda_ms(call)
    m = {tag: fft_acquire.peak_metrics(c, samples_per_code=spc,
                                       samples_per_chip=2)
         for tag, c in cubes.items()}
    a, b = m["sharded"], m["unsharded"]
    rel = (a["metric"] - b["metric"]).abs() / b["metric"].abs()
    res["metric_max_rel"] = float(rel.max())
    res["detected"] = [int(i) + 1 for i in torch.nonzero(
        b["metric"] > SEARCH_ACQ.threshold).flatten()]
    checks = {
        "code_phase equal": torch.equal(a["code_phase"], b["code_phase"]),
        "doppler_bin equal": torch.equal(a["doppler_bin"],
                                         b["doppler_bin"]),
        "metric within rtol 1e-5": res["metric_max_rel"] <= 1e-5,
        "the sky's PRNs detected": {3, 11, 23} <= set(res["detected"]),
    }
    return checked(res, checks)


#: Phase 32's weak satellite: 34 dB-Hz, which a 1 ms search misses and
#: 20 coherent code periods find; its Doppler sits on bin 20 of 41 bins
#: 25 Hz apart and its code phase on sample 1,024.
LC_SAT = SatParams(prn=7, doppler_hz=1250.0, code_phase_chips=511.5,
                   cn0_dbhz=34.0)
LC_K, LC_PRNS = 20, list(range(1, 33))
LC_DOPP = 750.0 + 25.0 * np.arange(41)


def lc_signal(device) -> np.ndarray:
    return IFSimulator(SIG, [LC_SAT], noise_sigma=1.0, seed=29,
                       device=device).generate(LC_K + 2)


def lc_cell(cube: torch.Tensor) -> list:
    """(PRN row, Doppler bin, code phase) of the cube's largest cell."""
    return [int(v) for v in np.unravel_index(int(torch.argmax(cube)),
                                             tuple(cube.shape))]


def lc_expected() -> list:
    spc = SIG.samples_per_code
    return [LC_PRNS.index(LC_SAT.prn), 20,
            int(round(LC_SAT.code_phase_chips * SIG.fs / SIG.code_freq))
            % spc]


def lc_oracle_err(x: np.ndarray, cube: torch.Tensor) -> float:
    """Largest |cube - f64 oracle| over the true PRN's row and two others,
    over the oracle's peak."""
    rows = [LC_PRNS.index(p) for p in (LC_SAT.prn, 3, 19)]
    oracle = reference_coherent_power(x, SIG, [LC_PRNS[r] for r in rows],
                                      LC_DOPP, LC_K)
    return float(np.max(np.abs(cube[rows].cpu().numpy() - oracle))
                 / oracle.max())


def lc_search(x, mesh, device, k: int = LC_K) -> tuple:
    """(cube, wall ms, peak device memory MB beyond the allocation before
    the call) of one long_coherent_acquire."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    cube = long_coherent_acquire(x, SIG, LC_PRNS, LC_DOPP, mesh,
                                 k_periods=k)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return cube, ms, (torch.cuda.max_memory_allocated(device) - base) / 2**20


def long_coherent_path(device) -> dict:
    """K = 20 code periods over time=4 (and time=1, the tail-only halo)
    on the weak satellite, against the f64 oracle on three PRN rows."""
    x = lc_signal(device)
    want = lc_expected()
    res = {"sat": dataclasses.asdict(LC_SAT), "k_periods": LC_K,
           "prns": len(LC_PRNS), "bins": len(LC_DOPP), "expected": want}
    cubes = {}
    for B in (4, 1):
        mesh, warned = quiet_mesh([("time", B)])
        lc_search(x, mesh, device)                 # warm-up (cuFFT plans)
        cube, ms, mb = lc_search(x, mesh, device)
        cubes[B] = cube
        res[f"time={B}"] = {"cell": lc_cell(cube), "ms": ms,
                            "peak_mb_all_shards_in_turn": mb,
                            "mesh_warning": warned}
    one_ms, _, _ = lc_search(x, quiet_mesh([("time", 1)])[0], device, k=1)
    res["1 ms search cell"] = lc_cell(one_ms)
    errs = {B: lc_oracle_err(x, c) for B, c in cubes.items()}
    res["oracle_max_norm_err"] = errs
    err_b1 = float(((cubes[4] - cubes[1]).abs().max()
                    / cubes[4].abs().max()).item())
    res["time=1 vs time=4 max_norm_err"] = err_b1
    c4 = res["time=4"]["cell"]
    checks = {
        "time=4 peak at the true PRN and bin": c4[:2] == want[:2],
        "time=4 code phase within 2 samples": abs(
            (c4[2] - want[2] + 1024) % 2048 - 1024) <= 2,
        "oracle within normalised atol 2e-3": max(errs.values()) <= 2e-3,
        "time=1 gives the same answer": res["time=1"]["cell"] == c4
        and err_b1 <= 2e-3,
        "a 1 ms search misses it": res["1 ms search cell"] != c4,
    }
    return checked(res, checks)


def timeblock_worker(coord: str, n: int, rank: int) -> int:
    """One rank of phase 33: phase 32's search over a time=n mesh of n
    processes (NCCL), one card each; prints its result as one line."""
    import torch.distributed as dist

    mesh = make_distributed_mesh([("time", n)], coordinator=coord,
                                 num_processes=n, process_id=rank)
    dev = mesh.first_device
    x = lc_signal(dev)
    lc_search(x, mesh, dev)
    cube, ms, mb = lc_search(x, mesh, dev)
    print("TIMEBLOCK " + json.dumps({
        "rank": rank, "world": dist.get_world_size(),
        "backend": dist.get_backend(), "device": str(dev),
        "collectives_through_the_group": mesh.distributed,
        "cell": lc_cell(cube), "oracle_max_norm_err": lc_oracle_err(x, cube),
        "ms": ms, "peak_mb": mb}), flush=True)
    dist.destroy_process_group()
    return 0


def distributed_path(cell: list) -> dict:
    """Phase 32's search in a torch.distributed world over NCCL on a
    localhost TCP store: two processes when there are two cards (time=2),
    else one (time=1, NCCL refuses two ranks on one card)."""
    n = 2 if torch.cuda.device_count() >= 2 else 1
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--timeblock-worker",
         coord, str(n), str(r)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = [json.loads(ln.split("TIMEBLOCK ", 1)[1])
               for out, _ in outs for ln in out.splitlines()
               if ln.startswith("TIMEBLOCK ")]
    res = {"processes": n, "rcs": [p.returncode for p in procs],
           "results": results,
           "stderr_tail": [err[-300:] for (_, err), p in zip(outs, procs)
                           if p.returncode]}
    checks = {
        "every rank exits 0": all(p.returncode == 0 for p in procs),
        "every rank reports": len(results) == n,
        "NCCL world of the processes": all(
            r["backend"] == "nccl" and r["world"] == n for r in results),
        "halo all-gather and all_reduce through NCCL": all(
            r["collectives_through_the_group"] for r in results),
        "peak in phase 32's cell": all(r["cell"] == cell for r in results),
        "oracle within normalised atol 2e-3": all(
            r["oracle_max_norm_err"] <= 2e-3 for r in results),
    }
    return checked(res, checks)


def cli_mesh_path(device, path: str) -> dict:
    """`python -m gnsstpu_torch track FILE ... --mesh channel=2` on phase
    28's file against the same command without --mesh: both exit 0 and
    their telemetry records (all but the wall-clock stamps and stage
    timings) are equal."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res, recs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, extra in (("unsharded", []),
                           ("mesh", ["--mesh", "channel=2"])):
            log = os.path.join(tmp, f"{tag}.jsonl")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "gnsstpu_torch", "track", path,
                 "--fs", "2.048e6", "--if-freq", "0", "--format", "i8_iq",
                 "--ms", "6000", "--channels", "8", "--epoch-ms", "500",
                 "--sync-every", "4", "--prefetch", "--readback",
                 "compact", "--device", device.type, "--log", log, *extra],
                cwd=repo, env=env, capture_output=True, text=True,
                timeout=600)
            res[tag] = {"rc": proc.returncode,
                        "wall_s": time.perf_counter() - t0,
                        "stdout_tail": proc.stdout.strip()[-120:],
                        "stderr_tail": (proc.stderr[-300:]
                                        if proc.returncode else "")}
            recs[tag] = []
            if os.path.exists(log):
                with open(log) as f:
                    recs[tag] = [
                        {k: v for k, v in json.loads(ln).items()
                         if k != "t"}
                        for ln in f if ln.strip()]
            recs[tag] = [r for r in recs[tag]
                         if r.get("type") != "task_health"]
    res["records"] = len(recs["mesh"])
    checks = {
        "both exit 0": all(r["rc"] == 0 for r in res.values()
                           if isinstance(r, dict)),
        "telemetry records equal": recs["mesh"] == recs["unsharded"]
        and len(recs["mesh"]) > 0,
    }
    return checked(res, checks)


def family_mesh_path(name: str, run, base: dict, base_snap: dict,
                     kernel: str) -> dict:
    """A K2 or K3 family's main path (run(src=..., mesh=...), phase 9's or
    13's) through ChannelManager(mesh=make_mesh([("channel", 2)])), held
    bit-identical to its unsharded run: the kernel launched once per
    shard per epoch, the state split over the mesh."""
    mesh, warned = quiet_mesh([("channel", 2)])
    res, _, snap = run(mesh=mesh)
    res["mesh"] = repr(mesh)
    res["mesh_warning"] = warned
    res["mismatches_unsharded"] = snapshot_mismatches(base_snap, snap)
    res["records_compared"] = len(snap["records"])
    res["streams_compared"] = sorted(int(p) for p in snap["streams"])
    checks = {
        f"{name}: records and prompt streams bit-identical":
            not res["mismatches_unsharded"] and res["records_compared"] > 0
            and len(res["streams_compared"]) > 0,
        f"{name}: {kernel} launched twice the unsharded count":
            res[f"{kernel}_launches"] == 2 * base[f"{kernel}_launches"] > 0,
        f"{name}: summary launched the unsharded count":
            res["summary_launches"] == base["summary_launches"] > 0,
        f"{name}: realtime_factor_overall >= 1":
            res["realtime_factor_overall"] >= 1.0,
        "no jax or gnsstpu module loaded": not refused_modules(),
    }
    return checked(res, checks)


#: Phase 36: the reference's integer-vs-float cross-check
#: (tests/test_gp2021_cosim.py:114-149: PRN 4 at -800 Hz, code phase 0,
#: 55 dB-Hz, noise sigma 0.35, seed 3, 500 ms, AcqConfig(coherent_ms=2),
#: 100 ms epochs), then the same at 12 channels: 12 PRNs in one IF, their
#: Dopplers spread over +-3 kHz and their code phases over the period.
#: There the float slots take the fine-Doppler handoff: from the coarse
#: 2 ms search's bin alone, a slot 80-120 Hz off has not pulled in by
#: 500 ms (the reference's manager alike), which the phase also reports.
COSIM_MS, COSIM_CN0, COSIM_SIGMA, COSIM_SEED = 500, 55.0, 0.35, 3
COSIM_ACQ = AcqConfig(coherent_ms=2)
COSIM_ACQ12 = AcqConfig(coherent_ms=2, fine_doppler_ms=10)
COSIM_REF = ((4, -800.0, 0.0),)
COSIM_SKY12 = tuple(
    (prn, float(d), float(c)) for prn, d, c in zip(
        (1, 3, 5, 7, 9, 11, 14, 17, 20, 23, 26, 29),
        np.linspace(-3000.0, 3000.0, 12), 37.25 + 85.5 * np.arange(12)))
#: The firmware's carrier guess is this far off the truth, as the
#: reference's (-780 Hz for -800).
COSIM_GUESS_HZ = 20.0


def _host_ms(fn, reps: int = 5) -> float:
    """Median host ms of fn() over reps calls after one warm-up."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ts))


def native_host_path(t_start: float, smi: str) -> dict:
    """Phase 36 (a)-(c) on the card's host: the native library built
    here from the checkout (no NumPy path in its place), its codecs and
    packers bit-identical to their NumPy twins on 2^22 seeded samples,
    sm2 packing of 1 s at 2.048 and 16 Msps, native against NumPy (host
    ms, median of 5), and the golden model's uint32 carrier NCO against
    ops/nco.freq_to_step_u32."""
    if not native.available():
        raise AssertionError("phase 36: the native library did not build "
                             "on this host (g++ and csrc/host/*.cpp)")
    lib = native._target()
    rng = np.random.default_rng(36)
    n = 1 << 22
    raws = {"decode_i8_iq": rng.integers(-128, 128, 2 * n, dtype=np.int8),
            "decode_i16_iq": rng.integers(-2 ** 15, 2 ** 15, 2 * n,
                                          dtype=np.int16),
            "decode_gn3s_2bit": rng.integers(0, 256, n, dtype=np.uint8),
            "decode_packed_4bit": rng.integers(0, 1 << 16, n // 4,
                                               dtype=np.uint16)}
    same = {name: bool(np.array_equal(getattr(native, name)(raw),
                                      getattr(wire, name)(raw)))
            for name, raw in raws.items()}
    x = rng.normal(0.0, 1.0, (n, 2)).astype(np.float32)
    for fmt, scale in (("iq8", 24.0), ("iq4", 3.0), ("sm2", 1.0),
                       ("iq1", 1.0)):
        same[f"pack_{fmt}"] = bool(np.array_equal(
            native.pack_wire(x, fmt, scale), up.pack_np(x, fmt, scale)))
    pack_ms = {}
    for fs in (2.048e6, FS16):
        xs = rng.normal(0.0, 1.0, (int(fs), 2)).astype(np.float32)
        pack_ms[f"{fs / 1e6:g} Msps"] = {
            "native": _host_ms(lambda: native.pack_wire(xs, "sm2", 1.0)),
            "numpy": _host_ms(lambda: up.pack_np(xs, "sm2", 1.0))}
    ch = native.Gp2021Channel(get_signal("gps_l1ca").code_fn(1))
    step = int(nco.freq_to_step_u32(9.548e3 + 4.13e5, SIG.fs))
    n_nco = 1_234_567
    ch.run(np.zeros(2 * n_nco, np.int8), step, code_step=0, max_dumps=1)
    got = int(ch.state["carr_phase"][0])
    want = n_nco * step % (1 << 32)
    return checked({
        "library": lib.name, "built_this_run": lib.stat().st_mtime
        >= t_start, "threads": native._threads(), "codec_samples": n,
        "bit_identical": same, "pack_sm2_1s_host_ms": pack_ms,
        "host_of": smi, "nco": {"steps": n_nco, "step": step,
                                "carr_phase": got, "want": want}}, {
        "codecs and packers bit-identical to NumPy": all(same.values()),
        "uint32 carrier phase = n x step mod 2^32": got == want})


def cosim_run(device, sky, acq: AcqConfig) -> dict:
    """Phase 36 (d) / (e): the sky's signal (the reference's draw,
    IFSimulator(noise="jax")) quantized to int8 for one integer GP2021
    channel per PRN under the firmware loop (native.cosim), each started
    at its satellite's code start and guessed COSIM_GUESS_HZ off its
    Doppler, and the same signal through the port's ChannelManager (K1,
    acquisition by acq) with one slot per PRN. Each PRN is held to the
    reference test's limits: the pull-in limits on the integer loop, both
    engines' prompt envelope stds and both Doppler means."""
    sats = [SatParams(prn=p, doppler_hz=d, code_phase_chips=c,
                      cn0_dbhz=COSIM_CN0) for p, d, c in sky]
    sim = IFSimulator(SIG, sats, noise_sigma=COSIM_SIGMA, seed=COSIM_SEED,
                      device=device, noise="jax")
    iq8 = cosim.quantize_iq8(sim.generate(COSIM_MS + 2))
    t0 = time.perf_counter()
    traces = {p: cosim.firmware_track(
        iq8, p, d + COSIM_GUESS_HZ, COSIM_MS,
        start=cosim.code_start_sample(c, d)) for p, d, c in sky}
    int_s = time.perf_counter() - t0
    cfg = ReceiverConfig(signal=SIG, acq=acq, n_channels=len(sky))
    reset_counts()
    t0 = time.perf_counter()
    mgr = ChannelManager(SimSource(sim, COSIM_MS + 20), cfg,
                         prn_pool=[p for p, _, _ in sky], epoch_ms=100,
                         device=device)
    mgr.run(COSIM_MS)
    if device.type == "cuda":
        torch.cuda.synchronize()
    mgr_s = time.perf_counter() - t0
    launches = dict(tk.LAUNCHES)
    rows, failed = {}, {}
    for p, d, c in sky:
        tr = traces[p]
        lim = cosim.pull_in_checks(tr, d)
        n_f = 0
        if p in mgr.history:
            h = mgr.prompt_stream(p)
            f_env = np.hypot(np.asarray(h["i_p"]), np.asarray(h["q_p"]))
            n_f = len(f_env)
        if n_f >= 200:
            lim.update(cosim.envelope_checks(np.hypot(tr["ip"], tr["qp"]),
                                             f_env))
            fd = float(np.mean(np.asarray(h["carr_doppler"])[-100:]) - d)
            lim["float |Doppler - truth| < 3 Hz"] = (fd, abs(fd) < 3.0)
        else:
            lim["float tracker: >= 200 prompts"] = (n_f, False)
        rows[p] = {"doppler_hz": d, "code_phase_chips": c,
                   "start_sample": cosim.code_start_sample(c, d),
                   "integer_dumps": len(tr["ip"]), "float_prompts": n_f,
                   **{k: round(float(v), 4) for k, (v, _) in lim.items()}}
        for k, (_, ok) in lim.items():
            failed.setdefault(k, [])
            if not ok:
                failed[k].append(p)
    checks = {f"every PRN: {k}": not v for k, v in failed.items()}
    checks["K1 launched, K2 and K3 not"] = (
        launches["track_chunk_fused"] > 0
        and launches["track_chunk_boc_fused"] == 0
        and launches["track_chunk_dual_fused"] == 0)
    checks["no jax or gnsstpu module loaded"] = not refused_modules()
    return checked({"prns": len(sky), "ms": COSIM_MS,
                    "integer_loops_host_s": round(int_s, 3),
                    "manager_wall_s": round(mgr_s, 3),
                    "k1_launches": launches["track_chunk_fused"],
                    "summary_launches": sk.LAUNCHES["epoch_summary"],
                    "decodes": up.DECODES["unpack"],
                    "failed_prns": {k: v for k, v in failed.items() if v},
                    "per_prn": rows}, checks)


#: bench_manager's limits in phase 37, phase 5's: ephemerides, fixes, the
#: last fix's error [m], and every sky SV live at the end.
BENCH_LIMITS = {"ephemerides": 8, "fixes": 10, "pos_err_m": 100.0,
                "live": GPS_CHANNELS - 1}


def bench_path() -> tuple:
    """Phase 37: `python -m gnsstpu_torch bench` in this process, so K1's
    launches are counted: (its JSON line, the phase's record with its
    checks)."""
    import contextlib
    import io

    from gnsstpu_torch.__main__ import main as cli_main

    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["bench"])
    wall = time.perf_counter() - t0
    launches = dict(tk.LAUNCHES)
    line = out.getvalue().strip().splitlines()[-1]
    ex = json.loads(line)["extra"]
    checks = {"exit 0": rc == 0}
    for C, rt in ex["tracking_scaling_channels_rt"].items():
        checks[f"C={C} realtime factor > 1"] = rt > 1.0
    checks["channel counts 12 / 48 / 192 / 768"] = sorted(
        ex["tracking_scaling_channels_rt"], key=int) == ["12", "48", "192",
                                                         "768"]
    checks["acquisition grid [32, 29, 2048]"] = (
        ex["acquisition_32prn_cold_search"]["grid"] == [32, 29, 2048])
    lim = BENCH_LIMITS
    for key in ("manager_end_to_end", "manager_device_resident"):
        m = ex[key]
        nav = m["navigator"]
        checks[f"{key}: navigator armed"] = nav["armed"]
        checks[f"{key}: >= {lim['ephemerides']} ephemerides"] = (
            nav.get("ephemerides_decoded", 0) >= lim["ephemerides"])
        checks[f"{key}: >= {lim['fixes']} fixes"] = (
            nav.get("pvt_solutions", 0) >= lim["fixes"])
        checks[f"{key}: last fix < {lim['pos_err_m']:g} m"] = (
            nav.get("pos_err_m", 1e9) < lim["pos_err_m"])
        checks[f"{key}: {lim['live']} live channels"] = (
            m["live_channels_at_end"] >= lim["live"])
        checks[f"{key}: engine fused"] = m["engine"] == "fused"
    checks["K1 launched, K2 and K3 not"] = (
        launches["track_chunk_fused"] > 0
        and launches["track_chunk_boc_fused"] == 0
        and launches["track_chunk_dual_fused"] == 0)
    refused = refused_modules()
    checks["no jax or gnsstpu module loaded"] = not refused
    return line, {"wall_s": wall, "k1_launches": launches[
        "track_chunk_fused"], "summary_launches": sk.LAUNCHES["epoch_summary"],
        "decodes": up.DECODES["unpack"],
        "refused_modules": refused, "checks": checks}


#: tests/test_joint_pvt.py:44-84: GPS L1 C/A and GLONASS L1OF on one
#: 4.096 Msps clock, 24 s each, 3 channels each, against one receiver.
JOINT_NMS = 24000
JSIG = SignalConfig(if_freq=0.0, fs=4.096e6, complex_iq=True)
JOINT_NAV = NavConfig(sol_period_ms=500, elevation_mask_deg=10.0,
                      use_tropo=False)
JOINT_EPOCHS = 10


def joint_setup() -> dict:
    """The reference test's two receivers: for "gps" and "glonass" the
    signal, sats, ReceiverConfig, SimSource length and seed, and the
    receiver position."""
    from gnsstpu_torch.sim.scenario import build_scenario

    chosen, recv = gps_solve_ephs()
    ephs_g = dict(list(chosen.items())[:3])
    sats_g = build_scenario(JSIG, ephs_g, recv, FC_TOW0_6S,
                            duration_s=JOINT_NMS / 1000.0, cn0_dbhz=47.0)
    cfg_g = ReceiverConfig(
        signal=JSIG,
        acq=AcqConfig(doppler_band=10e3, coherent_ms=2, threshold=2.4,
                      prn_list=tuple(ephs_g), fine_doppler_ms=10),
        track=TrackConfig(dll_bw=1.0, pll_bw=25.0, fll_bw=250.0),
        nav=JOINT_NAV, n_channels=3)
    gephs = make_glonass_constellation(recv, GFIX_TB, n=3)
    sats_r, qephs = build_scenario_glonass(
        OSIG4, gephs, recv, GFIX_T0, duration_s=JOINT_NMS / 1000.0,
        cn0_dbhz=48.0, n_strings=8)
    cfg_r = ReceiverConfig(
        signal=OSIG4,
        acq=AcqConfig(doppler_band=14e3, coherent_ms=2, threshold=2.5,
                      prn_list=tuple(qephs), fine_doppler_ms=10),
        track=OTRK, nav=JOINT_NAV, n_channels=3)
    return {"gps": dict(sig=JSIG, sats=sats_g, cfg=cfg_g,
                        src_ms=JOINT_NMS + 50, seed=21),
            "glonass": dict(sig=OSIG4, sats=sats_r, cfg=cfg_r,
                            src_ms=JOINT_NMS + 60, seed=31),
            "recv": recv}


def system_obs(out, sig, satpos_fn):
    """tests/test_joint_pvt.py::_system_obs on the port: one system's
    SystemObs from a ReceiverOutput, every channel advanced to the latest
    anchor time (navigate_from_anchors's alignment)."""
    from gnsstpu_torch.nav import pvt

    good = [c for c, ch in enumerate(out.channels)
            if ch.prn in out.ephs and out.anchors[c].found]
    period = sig.code_period_s
    t0 = max(out.anchors[c].t_anchor for c in good)
    sf = [out.anchors[c].anchor_idx
          + int(round((t0 - out.anchors[c].t_anchor) / period))
          for c in good]
    return pvt.SystemObs(
        prns=[out.channels[c].prn for c in good],
        abs_sample=out.track.abs_sample[good],
        subframe_start=sf, tow_s=t0, ephs=out.ephs,
        satpos_fn=satpos_fn, code_period_s=period, fs=sig.fs)


def joint_fix_checks(sol, recv) -> dict:
    """The joint solution's figures and tests/test_joint_pvt.py:108-124's
    limits on them."""
    v = sol.valid
    err = np.linalg.norm(np.stack([sol.x[v], sol.y[v], sol.z[v]], 1)
                         - recv, axis=1)
    inter = sol.inter_sys[v, 0]
    rec = {"valid_epochs": int(v.sum()), "epochs": int(len(v)),
           "mean_3d_err_m": float(err.mean()) if len(err) else None,
           "max_3d_err_m": float(err.max()) if len(err) else None,
           "inter_sys_bias_std_m": float(np.std(inter)) if len(err)
           else None,
           "n_sats": sorted({int(n) for n in sol.n_sats[v]})}
    rec["checks"] = {k: bool(v) for k, v in {
        ">= 8 of 10 epochs valid": rec["valid_epochs"] >= 8,
        "mean 3D < 30 m, max < 100 m": bool(len(err)) and err.mean() < 30.0
        and err.max() < 100.0,
        "inter-system bias std < 15 m": bool(len(err))
        and np.std(inter) < 15.0,
        "6 satellites in every valid epoch": rec["n_sats"] == [6],
    }.items()}
    return rec


def joint_fix_path(device, k1_ms: float) -> dict:
    """Phase 38, gps_glonass_joint_fix_6ch: the reference test's two
    receivers through the port's run_receiver on the card (K1 at blkp
    4,098 for both; each run first records its source's reads, then the
    timed run replays them), each alone without a fix, then one joint
    solve (SystemObs + navigate_joint) of all six satellites."""
    from gnsstpu_torch.nav import glonass as gl
    from gnsstpu_torch.nav import pvt
    from gnsstpu_torch.nav.orbits import satpos

    st = joint_setup()
    rec = {"blkp": JSIG.samples_per_code + 2}
    outs = {}
    for name in ("gps", "glonass"):
        s = st[name]
        src = ReplaySource(s["sig"], s["sats"], s["src_ms"], s["seed"],
                           device)
        out, r = offline_run(device, src, s["cfg"], JOINT_NMS,
                             "track_chunk_fused", k1_ms,
                             JOINT_NMS / 1000.0)
        r["alone"] = fix_errors(out.nav, st["recv"])
        outs[name], rec[name] = out, r
    t0 = time.perf_counter()
    sol = pvt.navigate_joint(
        [system_obs(outs["gps"], JSIG, satpos),
         system_obs(outs["glonass"], OSIG4, gl.satpos_gl)],
        JOINT_NAV, JOINT_EPOCHS)
    rec["joint_solve_s"] = time.perf_counter() - t0
    joint = joint_fix_checks(sol, st["recv"])
    rec["joint"] = joint
    rec["launches"] = rec["gps"]["launches"] + rec["glonass"]["launches"]
    checks = dict(joint.pop("checks"))
    for name in ("gps", "glonass"):
        r, out = rec[name], outs[name]
        checks[f"{name}: 3 ephemerides, no fix alone"] = (
            len(out.ephs) == 3 and out.nav is None)
        checks[f"{name}: K1 launched, no other"] = (
            r["launches"] > 0 and r["other_kernel_launches"] == 0)
        checks[f"{name}: no jax or gnsstpu module loaded"] = (
            not r["refused_modules"])
    rec["checks"] = checks
    return rec


#: Phase 39: the end-to-end examples, in the order they were ported, and
#: each one's seconds before its process is killed.
EXAMPLES = ("torch_e2e_gps_l1", "torch_e2e_position_fix",
            "torch_e2e_glonass_fix", "torch_e2e_joint_fix",
            "torch_e2e_multichip")
EXAMPLE_TIMEOUT_S = 120
EXAMPLE_TAG = "EXAMPLE-RESULT "

#: `python3 -c EXAMPLE_BOOT PATH DEVICE`: loads the example at PATH in an
#: interpreter whose import system refuses jax, jaxlib and gnsstpu (as
#: tests/test_torch_nojax.py does), calls its main(device=DEVICE) with
#: K1's launch counter at 0 and prints, after the example's own output,
#: one line tagged EXAMPLE_TAG: main()'s dict, its wall, every kernel's
#: launches and the refused modules loaded (none). A failing example
#: raises here.
EXAMPLE_BOOT = """
import importlib.abc, importlib.util, json, sys, time

REFUSED = ("jax", "jaxlib", "gnsstpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None


sys.meta_path.insert(0, Refuse())
path, device = sys.argv[1], sys.argv[2]
spec = importlib.util.spec_from_file_location("example", path)
example = importlib.util.module_from_spec(spec)
spec.loader.exec_module(example)
from gnsstpu_torch.ops import summary_kernel as sk
from gnsstpu_torch.ops import track_kernel as tk
from gnsstpu_torch.ops import unpack as up

tk.reset_launches()
up.reset_decodes()
t0 = time.perf_counter()
result = example.main(device=device)
wall = time.perf_counter() - t0
print("EXAMPLE-RESULT " + json.dumps({
    "result": result, "main_wall_s": wall,
    "launches": {**tk.LAUNCHES, **sk.LAUNCHES},
    "decodes": up.DECODES["unpack"],
    "refused_modules": sorted(m for m in sys.modules
                              if m.split(".")[0] in REFUSED)}), flush=True)
"""


def example_limits(name: str, r: dict) -> dict:
    """The reference script's PASS limits on an example's main() dict."""
    if name == "torch_e2e_gps_l1":
        return {"PRN 7 alone detected": r["detected_prns"] == [7],
                "ephemeris bit-exact": r["ephemeris_bit_exact"] is True,
                "TOW 44400 x 6 s": r["tow_s"] == 44400 * 6}
    if name == "torch_e2e_position_fix":
        return {"mean 3D error < 20 m": r["valid_epochs"] > 0
                and r["mean_3d_err_m"] < 20.0}
    if name == "torch_e2e_glonass_fix":
        return {"mean 3D error < 25 m": r["valid_epochs"] > 0
                and r["mean_3d_err_m"] < 25.0}
    if name == "torch_e2e_joint_fix":
        return {"neither system alone fixes":
                r["alone_fixes"] == [False, False],
                ">= 8 of 10 epochs valid": r["valid_epochs"] >= 8,
                "mean 3D error < 30 m": r["mean_3d_err_m"] < 30.0,
                "inter-system bias std < 15 m":
                    r["inter_sys_bias_std_m"] < 15.0}
    if name == "torch_e2e_multichip":
        return {"a live PRN": bool(r["live_prns"]),
                "state Sharded on the mesh, a part per shard":
                    r["state_parts"] is not None
                    and len(r["state_parts"]) == r["n_devices"]}
    raise ValueError(f"no example {name!r}")


def example_outcome(name: str, r: dict) -> str:
    """The example's decode outcome or fix error, for its line."""
    if name == "torch_e2e_gps_l1":
        return (f"PRN {r['detected_prns']}, ephemeris bit-exact "
                f"{r['ephemeris_bit_exact']}, TOW {r['tow_s']:g} s")
    if name == "torch_e2e_joint_fix":
        return (f"{r['valid_epochs']}/{r['epochs']} epochs, mean 3D error "
                f"{r['mean_3d_err_m']:.4f} m, bias std "
                f"{r['inter_sys_bias_std_m']:.4f} m")
    if name == "torch_e2e_multichip":
        return (f"live PRNs {r['live_prns']}, state parts "
                f"{r['state_parts']}")
    return (f"{r['valid_epochs']} epochs, mean 3D error "
            f"{r['mean_3d_err_m']:.4f} m, max {r['max_3d_err_m']:.4f} m")


def example_run(name: str) -> dict:
    """Phase 39 for one example: examples/NAME.py on the card in a fresh
    python3 process through EXAMPLE_BOOT, killed after EXAMPLE_TIMEOUT_S;
    its record with the reference's limits and the checks every example
    shares as 'checks'. A timeout, a non-zero exit or a missing result
    line raises."""
    repo = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(repo, "examples", name + ".py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-c", EXAMPLE_BOOT, path,
                               "cuda"], cwd=repo, env=env,
                              capture_output=True, text=True,
                              timeout=EXAMPLE_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"{name}: no result within "
                             f"{EXAMPLE_TIMEOUT_S} s") from e
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    tagged = [ln for ln in lines if ln.startswith(EXAMPLE_TAG)]
    if proc.returncode or not tagged:
        raise AssertionError(
            f"{name}: exit {proc.returncode}, no result line | stdout "
            f"{proc.stdout[-2000:]!r} | stderr {proc.stderr[-3000:]!r}")
    rec = json.loads(tagged[-1][len(EXAMPLE_TAG):])
    rec["process_wall_s"] = wall
    rec["last_printed"] = [ln for ln in lines
                           if not ln.startswith(EXAMPLE_TAG)][-1]
    launches = rec["launches"]
    checks = example_limits(name, rec["result"])
    checks["PASS printed"] = (rec["last_printed"] == "OK"
                              or "PASS" in rec["last_printed"])
    checks["K1 launched, K2 and K3 not"] = (
        launches["track_chunk_fused"] > 0
        and launches["track_chunk_boc_fused"] == 0
        and launches["track_chunk_dual_fused"] == 0)
    checks["no jax or gnsstpu module loaded"] = not rec["refused_modules"]
    return checked(rec, checks)


def main() -> int:
    t_start = time.time()
    # 1. Device.
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = smi_line()
    print(f"[1 device] {name} | nvidia-smi: {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. Build (every kernel, one nvcc per source, started together).
    t0 = time.perf_counter()
    built = tk.build_all()
    build_wall = time.perf_counter() - t0
    k1b = built["track_chunk_fused"]
    print(f"[2 build] four kernels in {build_wall:.2f} s wall; K1 "
          f"{k1b.path.name} built in {k1b.build_s:.2f} s; "
          f"{ptxas(k1b)}; K1 build record: "
          f"{json.dumps(k1_build_record(k1b))}", flush=True)

    # 3. K1 against its plain twin on the card, at six shapes.
    dev500, (k1_bound_ms, k1_bound_by) = k1_compare(12, 500, dev)
    k1_par = {"GPS 2.048 Msps C=12x500": dev500,
              "GPS 2.048 Msps C=9x6": k1_compare(9, 6, dev)[0],
              "GPS 2.048 Msps C=48x6": k1_compare(48, 6, dev)[0],
              "BeiDou B1I 4.096 Msps C=3x6": k1_compare(
                  3, 6, dev, BSIG, BTRK)[0],
              "GLONASS L1OF 8.192 Msps C=3x6": k1_compare(
                  3, 6, dev, OSIG, OTRK)[0],
              "GPS 16.384 Msps C=2x4": k1_compare(2, 4, dev, HSIG)[0]}
    print(f"[3 K1 parity] tolerances accumulators rtol 2e-3 atol 2, "
          f"carr_doppler 0.05 Hz, rem_code_phase 5e-4 chip | "
          + " | ".join(f"{k}: {json.dumps(v)}" for k, v in k1_par.items())
          + " | two launches bit-identical at all six shapes", flush=True)

    # 4. K1 time against the twin, its per-block floor and its split.
    k_ms, p_ms = k1_times(12, 1000, dev)
    k500_ms, p500_ms = k1_times(12, 500, dev)
    k48_ms, _ = k1_times(48, 500, dev, twin=False)
    floor_in = k1_floor_inputs(12, 500, dev)
    k1f_ms = kernel_times(floor_in, tk.track_chunk_fused, None)[0]
    gps_in = k1_inputs(12, 500, dev)
    splits = {"C=12x500": k1_split(gps_in, 500),
              "64-sample floor": k1_split(floor_in, 500)}
    print(f"[4 K1 time] C=12x1000 blocks (1.000 s of signal): kernel "
          f"{k_ms:.4f} ms (real-time factor {1000.0 / k_ms:.1f}), plain "
          f"twin {p_ms:.2f} ms (real-time factor {1000.0 / p_ms:.2f}); "
          f"C=12x500: kernel {k500_ms:.4f} ms ({1e3 * k500_ms / 500:.3f} "
          f"us per block), twin {p500_ms:.2f} ms; C=48x500: kernel "
          f"{k48_ms:.4f} ms ({1e3 * k48_ms / 500:.3f} us per block); "
          f"per-block floor (C=12x500 blocks of 64 samples) "
          f"{1e3 * k1f_ms / 500:.3f} us, so the chain floor at C=12x500 "
          f"is {k1f_ms:.4f} ms; bound at C=12x500 {k1_bound_ms:.5f} ms "
          f"({k1_bound_by}, one byte per tap); stamped instance split "
          f"(mean ns per block; chain {list(tk.FUSED_CHAIN)}): "
          + " | ".join(f"{k}: {json.dumps(v)}" for k, v in splits.items())
          + f"; on-chunk acquisition search {acq_search_ms(dev):.3f} ms",
          flush=True)

    # 40. The epoch summary kernel at the main path's shape.
    summ = summary_path(dev)
    sb = built["epoch_summary"]
    print(f"[40 epoch summary] C=12 x E=500 (K1's strided out), 8 slots of "
          f"a compact readback: kernel {summ['us']:.3f} us per launch, "
          f"plain version {summ['plain_us']:.3f} us per epoch, bound "
          f"{summ['bound_us']:.4f} us ({summ['bound_by']}, "
          f"{summ['bytes']} bytes); stream lanes bit-equal, stats within "
          f"{json.dumps(SUMMARY_TOL)}, locked equal in "
          f"{summ['locked_compared']} channel epochs away from the "
          f"thresholds ({summ['locked_plain_true']} locked), two fills "
          f"bit-identical; "
          f"{sb.path.name} built in {sb.build_s:.2f} s (beside K1-K3); "
          f"{ptxas(sb)}; {json.dumps(summ)}", flush=True)

    # 42. The wire decode at both cells' chunk sizes.
    dec = wire_decode_path(dev)
    print("[42 wire decode] table decode (int32 index cast + gather), "
          "card bit-identical to the CPU (sm2: and to the arithmetic) | "
          + " | ".join(f"{k}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} "
                       f"ms ({r['ms_over_bound']:.2f}x)"
                       + (f", arithmetic {r['arith_ms']:.4f} ms"
                          if "arith_ms" in r else "")
                       for k, r in dec.items()), flush=True)

    # 5. GPS main path.
    res, gps_src, gps_snap = gps_main_path(dev)
    gps_wire = gps_src.packed
    print(f"[5 main path] {json.dumps(res)}", flush=True)
    checks = {
        "live_channels_at_end >= 10": res["live_channels_at_end"] >= 10,
        "ephemerides_decoded >= 8": res["ephemerides_decoded"] >= 8,
        "pvt_solutions >= 10": res["pvt_solutions"] >= 10,
        "last_fix_err_m < 100": res.get("last_fix_err_m", 1e9) < 100.0,
        "k1_launches > 0": res["k1_launches"] > 0,
        "one summary launch per K1 launch":
            res["summary_launches"] == res["k1_launches"],
        "jax not imported": "jax" not in sys.modules,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}")

    # 6. K2 build record: its cluster launch and what the kernel uses.
    k2b = built["track_chunk_boc_fused"]
    rows_c = tboc.code_tap_rows(GSIG, GTRK, [1]).shape[1]
    rows_s = tboc.sub_tap_rows(GSIG, GTRK).shape[0]
    blkp2 = GSIG.samples_per_code + 2
    bp = tk.plane_stride(blkp2)
    rows2 = 12 * rows_c + rows_s
    k2_cl = cluster_line("track_chunk_boc_fused", 12, blkp2, k2b, dev)
    print(f"[6 K2 build] {k2b.path.name} built in {k2b.build_s:.2f} s "
          f"(in parallel with K1); {ptxas(k2b)}; cluster launch at C=12: "
          f"{json.dumps(k2_cl)}; tap tables at C=12: {1e-6 * 3 * bp * rows2:.1f}"
          f" MB (int8 E/P/L planes, {bp} lanes) against "
          f"{4e-6 * 3 * blkp2 * rows2:.1f} MB as f32 and "
          f"{4e-6 * 8 * bp * rows2:.1f} MB in the TPU layout", flush=True)

    # 7. K2 against its plain twin on the card.
    g125, (k2_bound_ms, k2_bound_by) = k2_compare(12, 125, dev)
    g6, _ = k2_compare(3, 6, dev)
    g48, _ = k2_compare(48, 6, dev)
    print(f"[7 K2 parity] tolerances {json.dumps(K2_TOL)} | C=12x125: "
          f"{json.dumps(g125)} | C=3x6: {json.dumps(g6)} | C=48x6 "
          f"(N, S = {tk.cluster_split(48, blkp2, n_sms)}): "
          f"{json.dumps(g48)} | two launches bit-identical at all three "
          f"shapes", flush=True)

    # 8. K2 time against the twin.
    k2_ms, k2p_ms = k2_times(12, 125, dev)
    k2l_ms, k2lp_ms = k2_times(12, 250, dev)
    print(f"[8 K2 time] C=12x125 blocks (0.500 s of signal): kernel "
          f"{k2_ms:.4f} ms (real-time factor {500.0 / k2_ms:.1f}), plain "
          f"twin {k2p_ms:.2f} ms; C=12x250 (1.000 s): kernel "
          f"{k2l_ms:.4f} ms (real-time factor {1000.0 / k2l_ms:.1f}), twin "
          f"{k2lp_ms:.2f} ms; bound at C=12x125 {k2_bound_ms:.5f} ms "
          f"({k2_bound_by})", flush=True)

    # 9. Galileo main path.
    gres, gal_src, gal_snap = galileo_main_path(dev)
    print(f"[9 galileo main path] {json.dumps(gres)}", flush=True)
    sky = gres["sky_prns"]
    refused = refused_modules()
    gchecks = {
        "every sky SV decoded": set(sky) <= set(gres["decoded_prns"]),
        "pvt_solutions >= 10": gres["pvt_solutions"] >= 10,
        "mean_3d_err_m < 30": (gres["mean_3d_err_m"] is not None
                               and gres["mean_3d_err_m"] < 30.0),
        "live_channels_at_end >= sky - 1":
            gres["live_channels_at_end"] >= len(sky) - 1,
        "k2_launches > 0": gres["k2_launches"] > 0,
        "no jax or gnsstpu module loaded": not refused,
    }
    failed = [k for k, ok in gchecks.items() if not ok]
    if failed:
        raise AssertionError(f"galileo main path checks failed: {failed} "
                             f"(modules: {refused[:5]})")

    # 10. K3 build record, its cluster launch and tap-table sizes at C=12.
    k3b = built["track_chunk_dual_fused"]
    R, _, bp3 = tdual.dual_table_shape(LSIG)
    blkp3 = LSIG.samples_per_code + 2
    k3_cl = cluster_line("track_chunk_dual_fused", 12, blkp3, k3b, dev)
    print(f"[10 K3 build] {k3b.path.name} built in {k3b.build_s:.2f} s "
          f"(in parallel with K1 and K2); {ptxas(k3b)}; cluster launch at "
          f"C=12: {json.dumps(k3_cl)}; tap table at C=12: "
          f"{12 * R * 6 * bp3 * 1e-6:.1f} MB (int8, 6 planes, {bp3} lanes)"
          f" against {12 * R * 8 * bp3 * 4e-6:.1f} MB in the TPU layout "
          f"(f32, 8 planes, lanes padded)", flush=True)

    # 11. K3 against its plain twin on the card.
    l500, (k3_bound_ms, k3_bound_by) = k3_compare(12, 500, dev)
    l6, _ = k3_compare(3, 6, dev)
    l48, _ = k3_compare(48, 8, dev)
    print(f"[11 K3 parity] tolerances {json.dumps(K3_TOL)} | C=12x500: "
          f"{json.dumps(l500)} | C=3x6: {json.dumps(l6)} | C=48x8 "
          f"(N, S = {tk.cluster_split(48, blkp3, n_sms)}): "
          f"{json.dumps(l48)} | two launches bit-identical at all three "
          f"shapes | bound at "
          f"C=12x500 {k3_bound_ms:.5f} ms ({k3_bound_by})", flush=True)

    # 12. K3 time against the twin.
    k3_ms, k3p_ms = k3_times(12, 500, dev)
    k3l_ms, k3lp_ms = k3_times(12, 1000, dev)
    k3w_ms, _ = k3_times(48, 500, dev, twin=False)
    k3w_cl = cluster_line("track_chunk_dual_fused", 48, blkp3, k3b, dev)
    k3f_ms = k3_floor_ms(12, 500, dev)
    print(f"[12 K3 time] C=12x500 blocks (0.500 s of signal at 24 Msps): "
          f"kernel {k3_ms:.4f} ms (real-time factor {500.0 / k3_ms:.1f}, "
          f"{1e3 * k3_ms / 500:.2f} us per block), plain twin "
          f"{k3p_ms:.2f} ms; C=12x1000 (1.000 s): kernel {k3l_ms:.4f} ms "
          f"(real-time factor {1000.0 / k3l_ms:.1f}), twin {k3lp_ms:.2f} "
          f"ms; C=48x500: kernel {k3w_ms:.4f} ms ({1e3 * k3w_ms / 500:.2f} "
          f"us per block; launch {json.dumps(k3w_cl)}); per-block floor "
          f"(C=12x500 blocks of 64 samples) {1e3 * k3f_ms / 500:.3f} us; "
          f"bound at C=12x500 {k3_bound_ms:.5f} ms ({k3_bound_by})",
          flush=True)

    # 13. GLONASS L3OC main path.
    lres, l3_src, l3_snap = l3_main_path(dev, k3_ms)
    print(f"[13 glonass l3oc main path] {json.dumps(lres)}", flush=True)
    refused = refused_modules()
    rows = lres["sky"].values()
    lchecks = {
        "every sky SV in a TRACKING slot": all(
            r["state"] == "tracking" for r in rows),
        "|last epoch's Doppler - truth| < 5 Hz": all(
            abs(r.get("doppler_err_hz", 1e9)) < 5.0 for r in rows),
        "C/N0 > 42 dB-Hz": all(r.get("cn0_dbhz", 0.0) > 42.0 for r in rows),
        "no absent SV confirmed": not set(lres["confirmed_prns"])
        & set(lres["absent_prns"]),
        "overlay sync quality >= 0.9": all(
            r.get("overlay_found") and r["overlay_quality"] >= 0.9
            for r in rows),
        "data bits bit-exact": all(r.get("bits_exact") for r in rows),
        "live_nav_unsupported once": lres["live_nav_unsupported_events"] == 1,
        "k3_launches > 0, K1 and K2 none": (lres["k3_launches"] > 0
                                            and lres["k1_launches"] == 0
                                            and lres["k2_launches"] == 0),
        "no jax or gnsstpu module loaded": not refused,
        "realtime_factor_overall >= 1": lres["realtime_factor_overall"] >= 1,
    }
    failed = [k for k, ok in lchecks.items() if not ok]
    if failed:
        raise AssertionError(f"glonass l3oc main path checks failed: "
                             f"{failed} (modules: {refused[:5]})")

    # 41. The L3OC on-chunk search: the whole bank, the pool, the absent.
    lsearch = l3_chunk_search_path(dev, l3_src)
    print(f"[41 glonass l3oc on-chunk search] {json.dumps(lsearch)}",
          flush=True)
    if lsearch["failed"]:
        raise AssertionError(f"glonass l3oc on-chunk search: "
                             f"{lsearch['failed']}")

    # 14. K1 alone at the BeiDou and GLONASS launch shapes.
    k1_new = {f"{tag} C=12x{n}": k1_alone(12, n, dev, sig, trk)
              for tag, sig, trk in (("BeiDou B1I 4.096 Msps", BSIG, BTRK),
                                    ("GLONASS L1OF 8.192 Msps", OSIG, OTRK))
              for n in (100, 500)}
    print("[14 K1 new shapes] kernel alone (its parity at these blkp: "
          "phase 3) | " + " | ".join(f"{k}: {json.dumps(v)}"
                                     for k, v in k1_new.items()),
          flush=True)

    # 15. BeiDou B1I main path.
    bres, _ = beidou_main_path(
        dev, k1_new["BeiDou B1I 4.096 Msps C=12x100"]["ms"])
    print(f"[15 beidou b1i main path] {json.dumps(bres)}", flush=True)
    k1_family_checks("beidou b1i main path", bres, 4, 30.0)

    # 16. GLONASS L1OF main path and its on-chunk FDMA search.
    ores, omgr = glonass_main_path(
        dev, k1_new["GLONASS L1OF 8.192 Msps C=12x100"]["ms"])
    osearch, _ = chunk_search_ms(omgr)
    del omgr
    print(f"[16 glonass l1of main path] {json.dumps(ores)} | on-chunk "
          f"FDMA search (14 channels x {OSIG.fs / 1e6:g} Msps, 2 x 2 ms "
          f"windows): {json.dumps(osearch)}", flush=True)
    k1_family_checks("glonass l1of main path", ores, 8, 25.0)
    if ores["on_chunk_searches"] < 1:
        raise AssertionError("glonass l1of main path: no on-chunk FDMA "
                             "search after the cold start")

    # 17. The manager's weak tier and checkpoint on the card.
    wres = weak_tier_path(dev)
    cres = checkpoint_path(dev)
    print(f"[17 manager features] weak tier: {json.dumps(wres)} | "
          f"checkpoint: {json.dumps(cres)}", flush=True)
    late = [ms for prn, ms in wres["channel_starts"] if prn == 12]
    fchecks = {
        "weak: search longer than a chunk":
            wres["chunk_shorter_than_search"],
        "weak: late SV found after 400 ms": bool(late) and late[0] >= 400,
        "weak: one host-path search, at epoch 0":
            wres["host_searches"] == [0],
        "weak: an accumulation finished on the card":
            "done" in wres["weak_steps"]
            and wres["cube_devices"] == ["cuda"],
        "weak: both SVs live at the end": wres["live_at_end"] == [5, 12],
        "checkpoint: state restored on the card":
            cres["restored_state_on"] == ["cuda"],
        "checkpoint: no channel_start or search after the resume":
            cres["channel_starts_after_resume"] == 0
            and not cres["host_searches_after_resume"],
        "checkpoint: both SVs live after the resume":
            cres["live_after_resume"] == [5, 12],
        "checkpoint: carrier phase equal to an uninterrupted run": all(
            all(v.values()) for v in cres["cph"].values()),
    }
    failed = [k for k, ok in fchecks.items() if not ok]
    if failed:
        raise AssertionError(f"manager feature checks failed: {failed}")

    # 19. The GPS main path fed over TCP as sm2 bytes, with a station.
    k1_gps_ms = k500_ms
    tres = gps_tcp_live_path(dev, gps_wire, k1_gps_ms)
    del gps_wire
    print(f"[19 gps_l1_tcp_live_12ch] {json.dumps(tres)} | phase 5 beside "
          f"it: live {res['live_channels_at_end']}, ephemerides "
          f"{res['ephemerides_decoded']}, fixes {res['pvt_solutions']}, "
          f"last-fix error {res.get('last_fix_err_m')} m, realtime factor "
          f"{res['realtime_factor_overall']:.2f}", flush=True)
    gps_tcp_checks(tres)

    # 20. The sky at 16 Msps, resampled on the card into the manager.
    k1_100_ms = kernel_times(k1_inputs(12, 100, dev), tk.track_chunk_fused,
                             None)[0]
    rres = gps_resampled_path(dev, k1_100_ms)
    print(f"[20 gps_l1_16msps_resampled_12ch] parity tolerance "
          f"{RESAMPLE_TOL:g} x the input's peak (float64 direct sum) | "
          f"{json.dumps(rres)}", flush=True)
    gps_resampled_checks(rres)

    # 21. The CLI on the card: track --listen with a station, monitor
    # tcp:// beside it, and a profiler trace.
    cres21 = cli_path(dev)
    print(f"[21 CLI] {json.dumps(cres21)}", flush=True)
    cli_checks(cres21)

    # 22-28. The offline chain, each kernel first timed alone at the
    # offline path's launch shape (CUDA events).
    k1_fc = k1_alone(6, 256, dev, SIG, TRK)
    sres = gps_solve_path(dev, k1_fc)
    print(f"[22 gps_l1_solve_8ch] {json.dumps(sres)}", flush=True)
    raise_failed("gps_l1_solve_8ch", sres)

    g_off, g_off_bound = k2_compare(5, 128, dev)
    k2_off_ms = kernel_times(k2_inputs(5, 128, dev),
                             tk.track_chunk_boc_fused, None)[0]
    gsres = galileo_solve_path(dev, k2_off_ms)
    print(f"[23 galileo_e1b_solve_5ch] K2 at C=5x128 against its twin "
          f"{json.dumps(g_off)}, bound {json.dumps(g_off_bound)} | "
          f"{json.dumps(gsres)}", flush=True)
    raise_failed("galileo_e1b_solve_5ch", gsres)

    k1_bd = k1_alone(5, 256, dev, BSIG, BTRK)
    bsres = beidou_solve_path(dev, k1_bd)
    print(f"[24 beidou_b1i_solve_6ch] {json.dumps(bsres)}", flush=True)
    raise_failed("beidou_b1i_solve_6ch", bsres)

    k1_glo = k1_alone(6, 256, dev, OSIG4, OTRK)
    osres = glonass_solve_path(dev, k1_glo)
    print(f"[25 glonass_l1of_solve_6ch] {json.dumps(osres)}", flush=True)
    raise_failed("glonass_l1of_solve_6ch", osres)

    l_off, l_off_bound = k3_compare(8, 256, dev)
    k3_off_ms = kernel_times(k3_inputs(8, 256, dev),
                             tk.track_chunk_dual_fused, None)[0]
    dres = l3_dual_path(dev, k3_off_ms)
    print(f"[26 glonass_l3oc_track_dual_8ch] K3 at C=8x256 against its "
          f"twin {json.dumps(l_off)}, bound {json.dumps(l_off_bound)} | "
          f"{json.dumps(dres)}", flush=True)
    raise_failed("glonass_l3oc_track_dual_8ch", dres)

    pres = pcode_path(dev)
    print(f"[27 pcode] {json.dumps(pres)}", flush=True)

    solve_dir = tempfile.TemporaryDirectory()
    solve_file = os.path.join(solve_dir.name, "gps.i8")
    write_solve_file(dev, solve_file)
    cres28 = cli_solve_path(dev, solve_file)
    print(f"[28 CLI solve] {json.dumps(cres28)}", flush=True)

    # 29. The GPS main path through a 2-way channel mesh.
    mres = gps_mesh_path(dev, gps_src, res, gps_snap)
    del gps_src, gps_snap
    print(f"[29 gps_l1_live_12ch_mesh2] {json.dumps(mres)} | phase 5 "
          f"beside it: realtime factor "
          f"{res['realtime_factor_overall']:.2f}, stage walls "
          f"{json.dumps(res['stage_wall_s'])}, K1 launches "
          f"{res['k1_launches']}", flush=True)
    raise_failed("gps_l1_live_12ch_mesh2", mres)

    # 30. Sharded K1 alone: C=48 x 500 over 4 shards on their streams.
    kres = sharded_k1_path(dev)
    print(f"[30 sharded K1] {json.dumps(kres)}", flush=True)
    raise_failed("sharded K1", kres)

    # 31. The cold search on a channel=2 x doppler=2 mesh.
    qres = sharded_search_path(dev)
    print(f"[31 sharded search] {json.dumps(qres)}", flush=True)
    raise_failed("sharded search", qres)

    # 32. Time-block long coherent acquisition of a weak satellite.
    lcres = long_coherent_path(dev)
    print(f"[32 long coherent] {json.dumps(lcres)}", flush=True)
    raise_failed("long coherent", lcres)

    # 33. The same search across torch.distributed processes (NCCL).
    dres33 = distributed_path(lcres["time=4"]["cell"])
    print(f"[33 distributed] {json.dumps(dres33)}", flush=True)
    raise_failed("distributed", dres33)

    # 34. track --mesh from the CLI against the same run without it.
    cres34 = cli_mesh_path(dev, solve_file)
    solve_dir.cleanup()
    print(f"[34 CLI track --mesh] {json.dumps(cres34)}", flush=True)
    raise_failed("CLI track --mesh", cres34)

    # 35. Galileo E1B and GLONASS L3OC through a 2-way channel mesh.
    fres = {}
    for tag, run, base, snap, kernel in (
            ("galileo_e1b_live_12ch_mesh2",
             lambda mesh: galileo_main_path(dev, src=gal_src, mesh=mesh),
             gres, gal_snap, "k2"),
            ("glonass_l3oc_live_12ch_mesh2",
             lambda mesh: l3_main_path(dev, k3_ms, src=l3_src, mesh=mesh),
             lres, l3_snap, "k3")):
        fres[tag] = family_mesh_path(tag, run, base, snap, kernel)
        print(f"[35 {tag}] {json.dumps(fres[tag])} | unsharded beside it: "
              f"realtime factor {base['realtime_factor_overall']:.2f}, "
              f"stage walls {json.dumps(base['stage_wall_s'])}, "
              f"{kernel.upper()} launches {base[kernel + '_launches']}",
              flush=True)
        raise_failed(tag, fres[tag])
    del gal_src, gal_snap, l3_src, l3_snap
    k2_mesh = fres["galileo_e1b_live_12ch_mesh2"]["k2_launches"]
    k3_mesh = fres["glonass_l3oc_live_12ch_mesh2"]["k3_launches"]

    # 36. The native library on the card's host and the GP2021
    # co-simulation against K1 through the manager, at 1 and 12 channels.
    nres = native_host_path(t_start, smi)
    raise_failed("gp2021 cosim: native library", nres)
    cres36 = {"reference_1ch": cosim_run(dev, COSIM_REF, COSIM_ACQ),
              "sky_12ch": cosim_run(dev, COSIM_SKY12, COSIM_ACQ12)}
    coarse = cosim_run(dev, COSIM_SKY12, COSIM_ACQ)
    k1_cosim = coarse["k1_launches"] + sum(r["k1_launches"]
                                           for r in cres36.values())
    coarse_err = {p: r.get("float |Doppler - truth| < 3 Hz")
                  for p, r in coarse["per_prn"].items()}
    print(f"[36 gps_l1_gp2021_cosim_12ch] native: {json.dumps(nres)} | "
          + " | ".join(f"{k}: {json.dumps(v)}" for k, v in cres36.items())
          + " | sky_12ch with the reference's coarse handoff "
          f"(AcqConfig(coherent_ms=2), not gated): failed "
          f"{json.dumps(coarse['failed_prns'])}, float Doppler error by "
          f"PRN {json.dumps(coarse_err)} | K1 launches {k1_cosim}",
          flush=True)
    for k, v in cres36.items():
        raise_failed(f"gp2021 cosim {k}", v)

    # 37. The bench command in this process.
    bench_line, bench_res = bench_path()
    print(f"[37 bench] {bench_line}", flush=True)
    print(f"[37 bench] {json.dumps(bench_res)}", flush=True)
    raise_failed("bench", bench_res)

    # 38. The joint GPS + GLONASS fix over the reference test's signals.
    k1_joint = k1_alone(3, 256, dev, JSIG, TRK)
    jres = joint_fix_path(dev, k1_joint["ms"])
    jres["k1_shape"] = k1_joint
    print(f"[38 gps_glonass_joint_fix_6ch] {json.dumps(jres)}", flush=True)
    raise_failed("gps_glonass_joint_fix_6ch", jres)

    # 39. The five end-to-end examples, each in a fresh process on the
    # card that refuses jax, jaxlib and gnsstpu.
    exres = {}
    for ex in EXAMPLES:
        r = exres[ex] = example_run(ex)
        res39 = r["result"]
        print(f"[39 {ex}] {'PASS' if all(r['checks'].values()) else 'FAIL'}"
              f" | wall {r['process_wall_s']:.2f} s (main "
              f"{r['main_wall_s']:.2f} s) | signal {res39['signal_s']:g} s,"
              f" {res39['signal_s'] / r['main_wall_s']:.2f} x real time | "
              f"{example_outcome(ex, res39)} | K1 launches "
              f"{r['launches']['track_chunk_fused']} | {json.dumps(r)}",
              flush=True)
        raise_failed(ex, r)

    # 18. K1's launches on each path (the examples' in their own
    # processes, read back; the CLI's uncounted; bench's in this one).
    k1_paths = {"gps_l1_live_12ch": res["k1_launches"],
                "gps_l1_live_12ch_mesh2": mres["k1_launches"],
                "beidou_b1i_live_12ch": bres["k1_launches"],
                "glonass_l1of_live_12ch": ores["k1_launches"],
                "gps_l1_tcp_live_12ch": tres["k1_launches"],
                "gps_l1_16msps_resampled_12ch": rres["k1_launches"],
                "gps_l1_solve_8ch": sres["launches"],
                "beidou_b1i_solve_6ch": bsres["launches"],
                "glonass_l1of_solve_6ch": osres["launches"],
                "gps_l1_gp2021_cosim_12ch": k1_cosim,
                "bench": bench_res["k1_launches"],
                "gps_glonass_joint_fix_6ch": jres["launches"]}
    k1_paths.update({ex: r["launches"]["track_chunk_fused"]
                     for ex, r in exres.items()})
    print(f"[18 K1 launches by path] {json.dumps(k1_paths)} | K2: "
          f"galileo_e1b_live_12ch {gres['k2_launches']}, "
          f"galileo_e1b_solve_5ch {gsres['launches']}, "
          f"galileo_e1b_live_12ch_mesh2 {k2_mesh} | K3: "
          f"glonass_l3oc_live_12ch {lres['k3_launches']}, "
          f"glonass_l3oc_track_dual_8ch {dres['launches']}, "
          f"glonass_l3oc_live_12ch_mesh2 {k3_mesh}", flush=True)
    # The epoch summary kernel's launches on each live path (one per
    # supervision epoch; the examples' read back from their processes).
    summary_paths = {
        "gps_l1_live_12ch": res["summary_launches"],
        "gps_l1_live_12ch_mesh2": mres["summary_launches"],
        "galileo_e1b_live_12ch": gres["summary_launches"],
        "glonass_l3oc_live_12ch": lres["summary_launches"],
        "beidou_b1i_live_12ch": bres["summary_launches"],
        "glonass_l1of_live_12ch": ores["summary_launches"],
        "gps_l1_tcp_live_12ch": tres["summary_launches"],
        "gps_l1_16msps_resampled_12ch": rres["summary_launches"],
        "gps_l1_gp2021_cosim_12ch": coarse["summary_launches"] + sum(
            r["summary_launches"] for r in cres36.values()),
        "bench": bench_res["summary_launches"],
        **{tag: r["summary_launches"] for tag, r in fres.items()}}
    summary_paths.update({ex: r["launches"]["epoch_summary"]
                          for ex, r in exres.items()})
    print(f"[18 summary launches by path] {json.dumps(summary_paths)}",
          flush=True)
    # The wire table's card decodes on each live path (one a superepoch
    # chunk fed in a wire format; none where the samples are f32).
    decode_paths = {
        "gps_l1_live_12ch": res["decodes"],
        "gps_l1_live_12ch_mesh2": mres["decodes"],
        "galileo_e1b_live_12ch": gres["decodes"],
        "glonass_l3oc_live_12ch": lres["decodes"],
        "beidou_b1i_live_12ch": bres["decodes"],
        "glonass_l1of_live_12ch": ores["decodes"],
        "gps_l1_tcp_live_12ch": tres["decodes"],
        "gps_l1_16msps_resampled_12ch": rres["decodes"],
        "gps_l1_gp2021_cosim_12ch": coarse["decodes"] + sum(
            r["decodes"] for r in cres36.values()),
        "bench": bench_res["decodes"],
        **{tag: r["decodes"] for tag, r in fres.items()}}
    decode_paths.update({ex: r["decodes"] for ex, r in exres.items()})
    print(f"[18 table decodes by path] {json.dumps(decode_paths)}",
          flush=True)

    print(json.dumps({"kernels": [
        {"name": "track_chunk_fused", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": sum(k1_paths.values()),
         "max_abs_err": dev500["acc_abs"], "ms": k500_ms,
         "plain_ms": p500_ms, "bound_ms": k1_bound_ms,
         "bound_by": k1_bound_by, "library_ms": None},
        {"name": "track_chunk_boc_fused", "route": "cuda",
         "source": K2_SOURCE, "replaces": K2_REPLACES,
         "launches": gres["k2_launches"] + gsres["launches"] + k2_mesh,
         "max_abs_err": g125["acc_abs"],
         "ms": k2_ms, "plain_ms": k2p_ms, "bound_ms": k2_bound_ms,
         "bound_by": k2_bound_by, "library_ms": None},
        {"name": "track_chunk_dual_fused", "route": "cuda",
         "source": K3_SOURCE, "replaces": K3_REPLACES,
         "launches": lres["k3_launches"] + dres["launches"] + k3_mesh,
         "max_abs_err": l500["acc_abs"],
         "ms": k3_ms, "plain_ms": k3p_ms, "bound_ms": k3_bound_ms,
         "bound_by": k3_bound_by, "library_ms": None},
        {"name": "epoch_summary", "route": "cuda",
         "source": SUMMARY_SOURCE, "replaces": SUMMARY_REPLACES,
         "launches": sum(summary_paths.values()),
         "max_abs_err": summ["stats_max_abs"]["cn0_dbhz"],
         "ms": 1e-3 * summ["us"], "plain_ms": 1e-3 * summ["plain_us"],
         "bound_ms": 1e-3 * summ["bound_us"],
         "bound_by": summ["bound_by"], "library_ms": None},
    ]}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--timeblock-worker"]:
        sys.exit(timeblock_worker(sys.argv[2], int(sys.argv[3]),
                                  int(sys.argv[4])))
    sys.exit(main())
