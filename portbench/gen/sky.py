"""The benchmark's skies, drawn from --seed. Each signal is a module of its
own, signals/<signal>.py, found by the configuration's signal name as a
metric's reader is found by its name (plan.signal): its codes, its sky and
the broadcast fields a decoder must read. This module holds what every
sky shares: the truth of one code stream (Sat), the front end (Signal)
and a recording's truth (Sky).

The seed draws what a recording of the same deployment would vary. It
never changes how many satellites are in the sky, how many are absent,
their C/N0 or the length of the recording.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np

from portbench import plan


@dataclasses.dataclass
class Sat:
    """Truth of one transmitted code stream (the port's SatParams)."""

    prn: int
    doppler_hz: float = 0.0
    doppler_rate: float = 0.0
    if_offset_hz: float = 0.0
    code_phase_chips: float = 0.0
    carrier_phase: float = 0.0
    cn0_dbhz: float = 45.0
    nav_bits: Optional[np.ndarray] = None


@dataclasses.dataclass
class Signal:
    """Front end and signal: what the IF simulator needs, with the
    signal's module (plan.signal)."""

    name: str
    fs: float
    if_freq: float
    code_freq: float
    code_length: int
    carrier_hz: float
    bit_len_codes: int
    module: object = dataclasses.field(default=None, compare=False,
                                       repr=False)

    @property
    def samples_per_code(self) -> int:
        return round(self.fs * self.code_length / self.code_freq)

    def code(self, prn: int) -> np.ndarray:
        return self.module.code(prn)


@dataclasses.dataclass
class Sky:
    """A recording's truth: the streams, the satellites the receiver
    should find and those it should not, and what they carry."""

    signal: Signal
    sats: list                      # Sat per code stream
    prns: list                      # satellites in the sky
    absent: list                    # pool PRNs not in the sky
    recv_ecef: Optional[np.ndarray] = None
    #: {prn: ephemeris} broadcast by a signal that carries ephemerides
    #: (empty otherwise): the decoder must read the signal module's
    #: broadcast(eph) of each, and fixes are judged against recv_ecef.
    ephs: dict = dataclasses.field(default_factory=dict)
    #: Receive time [s from the recording's start] by which every
    #: satellite's ephemeris has been on the air in full.
    ephemeris_on_air_s: Optional[float] = None


def signal_of(cfg: dict, base: Path = plan.HERE) -> Signal:
    s = cfg["signal"]
    return Signal(name=s["signal"], fs=float(s["fs"]),
                  if_freq=float(s["if_freq"]),
                  code_freq=float(s["code_freq"]),
                  code_length=int(s["code_length"]),
                  carrier_hz=float(s["carrier_hz"]),
                  bit_len_codes=int(s["bit_len_codes"]),
                  module=plan.signal(s["signal"], base))


def make_sky(cfg: dict, traffic: dict, seed: int,
             base: Path = plan.HERE) -> Sky:
    """The sky of a cell's configuration and traffic mix for one seed,
    made by signals/<signal>.py under base."""
    sig = signal_of(cfg, base)
    return sig.module.sky(sig, traffic, seed)
