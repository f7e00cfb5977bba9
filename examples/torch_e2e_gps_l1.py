"""End-to-end GPS L1 C/A demo on the PyTorch + CUDA port: simulate ->
acquire -> track -> decode.

examples/e2e_gps_l1.py on gnsstpu_torch, with its scenario, seeds,
constants, printed steps and PASS limits: an IF stream carrying real
LNAV frames for one SV, cold-acquired, tracked, bit/frame-synced, and
the broadcast ephemeris decoded, which must match what was encoded,
bit-exactly. The script imports torch, numpy and gnsstpu_torch only.

The signal is made on the device by the port's simulator with the
reference's noise (IFSimulator(noise="jax"): jax.random's draws, made
without JAX), so it is the very signal the reference script tracks.
Tracking runs the fused engine, kernel K1 (gnsstpu_torch/csrc/
track_fused.cu; its plain twin on the CPU), one launch per 250 ms chunk.

Run: python examples/torch_e2e_gps_l1.py [--device cuda|cpu]

The device is the card unless --device says otherwise; without a card
the script raises. main(device) returns a dict of what it checked.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from gnsstpu_torch.acquisition.search import (acq_samples_needed,  # noqa: E402
                                              acquire)
from gnsstpu_torch.config import (AcqConfig, SignalConfig,  # noqa: E402
                                  TrackConfig)
from gnsstpu_torch.device import resolve_device  # noqa: E402
from gnsstpu_torch.nav import Ephemeris, frame, lnav  # noqa: E402
from gnsstpu_torch.runtime.sources import SimSource  # noqa: E402
from gnsstpu_torch.sim import IFSimulator, SatParams  # noqa: E402
from gnsstpu_torch.tracking.driver import ChannelInit, track  # noqa: E402

SIG = SignalConfig(if_freq=0.0, fs=2.048e6, complex_iq=True)
ACQ = AcqConfig(doppler_band=10e3, coherent_ms=2, threshold=2.5)
TRK = TrackConfig(dll_bw=1.0, pll_bw=25.0, fll_bw=250.0)

EPH = Ephemeris(
    week=202, accuracy=1, health=0, T_GD=-4.656e-9, IODC=311,
    t_oc=266400.0, a_f2=0.0, a_f1=-3.2e-12, a_f0=2.45e-4,
    IODE_sf2=55, C_rs=-12.8125, deltan=4.2e-9, M_0=1.23456,
    C_uc=-6.7e-7, e=0.0123456, C_us=8.1e-6, sqrtA=5153.712,
    t_oe=266400.0, C_ic=-7.45e-8, omega_0=-2.0312, C_is=1.12e-7,
    i_0=0.96123, C_rc=221.5625, omega=-1.87654, omegaDot=-8.1e-9,
    IODE_sf3=55, iDot=4.0e-10,
)
TOW0 = 44400        # truncated TOW (6 s units) of first encoded subframe
N_MS = 21000
CHUNK_MS = 250
SEED = 13


def satellite() -> SatParams:
    """PRN 7 with 2 s of filler bits (covers the tracking pull-in
    transient), then five real LNAV subframes. The last two filler bits
    are 0 (+1) because the encoder parity chain starts at D29*=D30*=0."""
    rng = np.random.default_rng(5)
    filler = rng.choice([-1.0, 1.0], size=100)
    filler[-2:] = 1.0
    nav = np.concatenate([filler, lnav.encode_frames(EPH, tow0=TOW0)])
    return SatParams(prn=7, doppler_hz=1836.0, code_phase_chips=412.4,
                     cn0_dbhz=45.0, nav_bits=nav)


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    t0 = time.time()
    sat = satellite()
    n_ms = N_MS
    sim = IFSimulator(SIG, [sat], noise_sigma=1.0, seed=SEED, device=dev,
                      noise="jax")
    src = SimSource(sim, n_ms + 50)
    print(f"[{time.time()-t0:6.1f}s] simulator ready "
          f"({n_ms} ms @ {SIG.fs/1e6:.3f} Msps, C/N0 {sat.cn0_dbhz} dB-Hz, "
          f"on {dev})")

    res = acquire(src.read(0, acq_samples_needed(SIG, ACQ)), SIG, ACQ,
                  device=dev)
    print(f"[{time.time()-t0:6.1f}s] acquisition: detected PRNs "
          f"{res.detected_prns()}, metric "
          f"{res.peak_metric[sat.prn-1]:.1f}, doppler "
          f"{res.carr_freq[sat.prn-1]:+.0f} Hz, code phase "
          f"{res.code_phase[sat.prn-1]} samples")
    assert res.detected_prns() == [sat.prn], "acquisition failed"

    ch = ChannelInit(prn=sat.prn,
                     code_phase=int(res.code_phase[sat.prn - 1]),
                     doppler_hz=float(res.carr_freq[sat.prn - 1]))
    tr = track(src, [ch], SIG, TRK, n_ms, chunk_ms=CHUNK_MS, device=dev)
    cn0_proxy = 10 * np.log10(
        np.mean(tr.i_p[0, 2000:] ** 2)
        / max(np.var(tr.q_p[0, 2000:]), 1e-9) * 1000.0)
    mean_doppler = float(np.mean(tr.carr_freq[0, 2000:]))
    print(f"[{time.time()-t0:6.1f}s] tracking done: mean doppler "
          f"{mean_doppler:+.1f} Hz "
          f"(truth {sat.doppler_hz:+.1f}), C/N0 proxy {cn0_proxy:.1f} dB-Hz")

    sync = frame.find_preamble(tr.i_p[0])
    assert sync.found, "no preamble found"
    print(f"[{time.time()-t0:6.1f}s] frame sync: first subframe at "
          f"{sync.first_subframe_ms} ms, polarity {sync.polarity:+d}")

    bits = frame.bits_from(tr.i_p[0], sync)
    dec, tow = lnav.decode_subframes(bits, d30_star=sync.d30_star)
    assert dec.valid, "ephemeris decode failed (parity)"
    print(f"[{time.time()-t0:6.1f}s] ephemeris decoded: TOW {tow} s, "
          f"week {dec.week}, sqrtA {dec.sqrtA:.3f}, e {dec.e:.7f}")

    # Bit-exact round-trip check against the encoded quantization.
    assert dec.week == EPH.week and dec.IODC == EPH.IODC
    for f, lsb in (("sqrtA", 2.0 ** -19), ("e", 2.0 ** -33),
                   ("M_0", 2.0 ** -31 * np.pi),
                   ("omega_0", 2.0 ** -31 * np.pi),
                   ("i_0", 2.0 ** -31 * np.pi)):
        want = round(getattr(EPH, f) / lsb) * lsb
        got = getattr(dec, f)
        assert abs(got - want) < 1e-12 * max(1.0, abs(want)), f
    assert tow == TOW0 * 6
    wall = time.time() - t0
    print(f"[{wall:6.1f}s] PASS: decoded ephemeris is bit-exact "
          f"vs encoded truth")
    return {"signal_s": n_ms / 1000.0, "wall_s": wall,
            "detected_prns": res.detected_prns(),
            "code_phase": int(res.code_phase[sat.prn - 1]),
            "acq_doppler_hz": float(res.carr_freq[sat.prn - 1]),
            "mean_doppler_hz": mean_doppler,
            "first_subframe_ms": int(sync.first_subframe_ms),
            "tow_s": float(tow), "ephemeris_bit_exact": True}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without a "
                    "card)")
    main(ap.parse_args().device)
