"""Receiver configuration.

A single typed dataclass tree replaces the reference's scattered config
mechanisms (Scilab `initSettings.sci` structs — e.g. reference
`POSTPROCESSING_SCILAB_RECEIVERS/GPS/L1/initSettings.sci:41-126`; C++
compile-time `includes/config.h`; and the osgnss `include/globals.h`).

All values are plain Python scalars so configs are hashable/static under jit.

Copied from gnsstpu/config.py; only the import prefix differs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SignalConfig:
    """Front-end + signal parameters (one constellation/signal)."""

    # Signal identity — key into gnsstpu.signals.registry.
    signal: str = "gps_l1ca"
    # Intermediate frequency of the recorded stream [Hz].
    # (ref GPS/L1/initSettings.sci:68 — IF = 2.42e6 for the 16 Msps front end)
    if_freq: float = 2.42e6
    # Sampling frequency [Hz]. (ref initSettings.sci:69)
    fs: float = 16.0e6
    # Chipping rate of the ranging code [Hz]. (ref initSettings.sci:70)
    code_freq: float = 1.023e6
    # Chips per code period. (ref initSettings.sci:73)
    code_length: int = 1023
    # True if samples are complex I/Q, False if real. (ref fileType, :65)
    complex_iq: bool = True
    # FDMA carrier offset step [Hz] per frequency channel (GLONASS); 0 = CDMA.
    fdma_step: float = 0.0

    @property
    def code_period_s(self) -> float:
        return self.code_length / self.code_freq

    @property
    def code_period_ms(self) -> float:
        return 1e3 * self.code_length / self.code_freq

    @property
    def samples_per_code(self) -> int:
        return round(self.fs * self.code_length / self.code_freq)


@dataclasses.dataclass(frozen=True)
class AcqConfig:
    """FFT code-phase × Doppler search parameters.

    (ref GPS/L1/acquisition.sci:45-192 and realtime acquisition.cpp tiers)
    """

    # Doppler search band around IF [Hz] (total width).
    # (ref initSettings.sci:82 — acqSearchBand = 14 kHz)
    doppler_band: float = 14e3
    # Coherent integration [code periods] (ref initSettings.sci:87).
    coherent_ms: int = 4
    # Noncoherent accumulations (1 = none; reference "weak" tier uses 15,
    # acquisition.cpp:433). >1 switches window combining from max to sum.
    noncoherent: int = 1
    # Number of coherent windows searched (stride = coherent_ms); with
    # noncoherent == 1 they are max-combined: 2 = the classic alternating
    # bit-flip dodge (acquisition.sci:126-132), 7/4 with coherent_ms=3/5 =
    # the COMPASS NH(20)-straddling schemes (COMPASS/B1/acquisition_7x3ms
    # .sci, acquisition_4x5ms.sci). None -> 2, or `noncoherent` if > 1.
    n_windows: Optional[int] = None
    # peak/second-peak detection threshold (ref initSettings.sci:84).
    threshold: float = 3.0
    # Post-detection fine-Doppler estimate: ms of code-wiped signal for
    # the squared-signal FFT (reference Channel::FrequencyLock,
    # objects/channel.cpp:359-417). 0 = off (hand off the coarse bin).
    fine_doppler_ms: int = 0
    # Doppler bin step [Hz]; None → 1000/(2*coherent_ms) like the reference
    # (acquisition.sci:101-104).
    doppler_step: Optional[float] = None
    # PRNs to search; None → all PRNs of the signal.
    prn_list: Optional[Tuple[int, ...]] = None

    def doppler_bin_step(self) -> float:
        if self.doppler_step is not None:
            return self.doppler_step
        return 1000.0 / (2.0 * self.coherent_ms)

    def num_doppler_bins(self) -> int:
        return round(self.doppler_band / self.doppler_bin_step()) + 1

    # --- acquisition tiers (reference objects/acquisition.cpp:244/309/433:
    # strong = 1 ms coherent; medium = 10 ms coherent; weak = 10 ms
    # coherent x 15 noncoherent over a 310 ms buffer) and the COMPASS
    # NH(20)-straddling schemes (COMPASS/B1/acquisition_7x3ms.sci,
    # acquisition_4x5ms.sci, selected by acqMode in postProcessing.sce:
    # 106-112) ---

    def strong(self, **kw) -> "AcqConfig":
        return dataclasses.replace(self, coherent_ms=1, noncoherent=1,
                                   n_windows=None, **kw)

    def medium(self, **kw) -> "AcqConfig":
        return dataclasses.replace(self, coherent_ms=10, noncoherent=1,
                                   n_windows=None, **kw)

    def weak(self, noncoherent: int = 15, **kw) -> "AcqConfig":
        return dataclasses.replace(self, coherent_ms=10,
                                   noncoherent=noncoherent, **kw)

    def nh_7x3(self, **kw) -> "AcqConfig":
        """BeiDou D1 NH(20) straddling: 7 x 3 ms max-combined windows."""
        return dataclasses.replace(self, coherent_ms=3, noncoherent=1,
                                   n_windows=7, **kw)

    def nh_4x5(self, **kw) -> "AcqConfig":
        """BeiDou D1 NH(20) straddling: 4 x 5 ms max-combined windows."""
        return dataclasses.replace(self, coherent_ms=5, noncoherent=1,
                                   n_windows=4, **kw)


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    """DLL/PLL/FLL loop parameters (ref initSettings.sci:89-98)."""

    dll_damping: float = 0.7
    dll_bw: float = 0.1          # [Hz] code loop noise bandwidth
    el_spacing: float = 0.2      # [chips] early-late correlator offset
    pll_bw: float = 25.0         # [Hz] carrier phase loop bandwidth
    fll_bw: float = 250.0        # [Hz] carrier frequency-assist bandwidth
    # Carrier-aiding divisor: f_code = code_freq - nco + (f_carr-IF)/aid_div.
    # 1540 = 1575.42 MHz / 1.023 MHz for GPS L1 (ref tracking.sci:334).
    aid_div: float = 1540.0
    # Integration (code period) time [s] per loop update.
    pdi: float = 1e-3
    # FLL discriminator: "atan2" (4-quadrant, widest pull-in; reference
    # tracking.sci:292-299) or "atan" (2-quadrant decision-directed —
    # immune to data/secondary-code sign flips between consecutive code
    # periods, required for BeiDou D1 NH(20) whose symbol rate equals the
    # code-period rate).
    fll_disc: str = "atan2"
    # Subcarrier lock loop (Galileo E1 double-estimator only; reference
    # GALILEO/E1/initSettings.sci:100-103).
    sll_bw: float = 0.5          # [Hz] meandr loop noise bandwidth
    sll_damping: float = 0.7
    sll_spacing: float = 0.1     # [meandr half-chips] SLL E-L offset


@dataclasses.dataclass(frozen=True)
class NavConfig:
    """Navigation solution parameters (ref initSettings.sci:100-115)."""

    sol_period_ms: int = 500
    elevation_mask_deg: float = 10.0
    use_tropo: bool = True
    # Initial assumed signal travel time [ms] (ref initSettings.sci:125).
    start_offset_ms: float = 68.802
    lsq_iterations: int = 7
    # Steer the epoch transmit-time advance by the solved clock drift
    # (the real-time receiver's clock steering, objects/pvt.cpp:379).
    clock_steering: bool = False
    # Apply the broadcast Klobuchar iono correction when a decoded
    # alpha/beta page is available (nav.iono; the reference decodes but
    # never applies it, objects/ephemeris.cpp:314).
    use_iono: bool = False
    # Hatch carrier-smoothing window [s] (0 = off): blend each epoch's
    # code pseudorange with the carrier-phase-propagated prediction —
    # enabled by the integrated-carrier-phase stream the reference
    # latches but never exploits (correlator.cpp TakeMeasurements).
    # Keep <= ~100 s single-frequency (code/phase iono divergence).
    carrier_smoothing_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class ReceiverConfig:
    """Top-level receiver configuration."""

    signal: SignalConfig = dataclasses.field(default_factory=SignalConfig)
    acq: AcqConfig = dataclasses.field(default_factory=AcqConfig)
    track: TrackConfig = dataclasses.field(default_factory=TrackConfig)
    nav: NavConfig = dataclasses.field(default_factory=NavConfig)
    n_channels: int = 8
    ms_to_process: int = 44000


SPEED_OF_LIGHT = 299792458.0
