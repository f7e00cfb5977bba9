"""Signal registry: maps signal names to code generators and metadata.

The registry is the framework's equivalent of the reference's per-receiver
directory layout (GPS/L1, GLONASS/L1..L3, GALILEO/E1, COMPASS/B1 under
POSTPROCESSING_SCILAB_RECEIVERS) — one entry per supported signal.

Copied from gnsstpu/signals/registry.py; only the import prefix differs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SignalDef:
    name: str
    # Carrier frequency of PRN/channel k [Hz] (callable for FDMA).
    carrier_freq: Callable[[int], float]
    code_freq: float
    code_length: int
    # code_fn(prn) -> ±1 int8 [code_length]
    code_fn: Callable[[int], np.ndarray]
    num_prn: int
    # Data bit (or meander/secondary-code) period in code periods.
    bit_len_codes: int
    # Secondary (overlay) code, ±1 int8, or None.
    secondary: Optional[np.ndarray] = None
    # FDMA: registry prn of the zero frequency channel (None = CDMA).
    fdma_zero_prn: Optional[int] = None
    # Carrier-aiding divisor f_carrier / f_code.
    @property
    def aid_div(self) -> float:
        return self.carrier_freq(0) / self.code_freq


_REGISTRY: Dict[str, SignalDef] = {}


def register(sd: SignalDef) -> SignalDef:
    _REGISTRY[sd.name] = sd
    return sd


def get_signal(name: str) -> SignalDef:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown signal {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def _register_builtin() -> None:
    from gnsstpu_torch.signals import glonass, gps_l1ca

    register(
        SignalDef(
            name="gps_l1ca",
            carrier_freq=lambda prn: 1575.42e6,
            code_freq=1.023e6,
            code_length=1023,
            code_fn=gps_l1ca.generate_ca_code,
            num_prn=32,
            bit_len_codes=20,  # 50 bps LNAV over 1 ms codes
        )
    )
    register(
        SignalDef(
            name="glonass_l1of",
            carrier_freq=glonass.l1of_carrier,
            code_freq=glonass.CODE_FREQ,
            code_length=glonass.CODE_LENGTH,
            code_fn=glonass.st_code_for_prn,
            num_prn=glonass.NUM_FREQ_CH,
            # 100 sps symbols (50 bps data x meander / time-mark bits):
            # 10 code periods of 1 ms per symbol.
            bit_len_codes=10,
            fdma_zero_prn=8,
        )
    )
    from gnsstpu_torch.signals import beidou_b1

    register(
        SignalDef(
            name="beidou_b1i",
            carrier_freq=lambda prn: beidou_b1.CARRIER_HZ,
            code_freq=beidou_b1.CODE_FREQ,
            code_length=beidou_b1.CODE_LENGTH,
            code_fn=beidou_b1.generate_b1i_code,
            num_prn=beidou_b1.NUM_PRN,
            # D1 symbols change every code period (data bit x NH chip):
            # simulate at 1 code period per "bit"; the NH structure lives
            # in nav.beidou.
            bit_len_codes=1,
            secondary=beidou_b1.NH_CODE,
        )
    )
    from gnsstpu_torch.signals import galileo_e1

    register(
        SignalDef(
            name="galileo_e1b",
            carrier_freq=lambda prn: galileo_e1.CARRIER_HZ,
            # Composite BOC(1,1) replica at the half-chip ("meandr") rate
            # so acquisition/simulation see the true spectrum; the
            # double-estimator tracker (tracking.boc) splits code and
            # subcarrier again.
            code_freq=galileo_e1.SUB_FREQ,
            code_length=galileo_e1.SUB_LENGTH,
            code_fn=galileo_e1.composite_code,
            num_prn=galileo_e1.NUM_PRN,
            # 250 sps I/NAV symbols: one symbol per 4 ms code period.
            bit_len_codes=1,
        )
    )
    from gnsstpu_torch.signals import glonass_l3

    register(
        SignalDef(
            name="glonass_l3oc",
            carrier_freq=lambda prn: glonass_l3.CARRIER_HZ,
            code_freq=glonass_l3.CODE_FREQ,
            code_length=glonass_l3.CODE_LENGTH,
            code_fn=glonass_l3.generate_l3_code,
            num_prn=glonass_l3.NUM_PRN,
            # Overlay chips (NH(10) pilot / Barker(5) x 200 sps data) change
            # every 1 ms code period.
            bit_len_codes=1,
        )
    )
    register(
        SignalDef(
            name="glonass_l2of",
            carrier_freq=glonass.l2of_carrier,
            code_freq=glonass.CODE_FREQ,
            code_length=glonass.CODE_LENGTH,
            code_fn=glonass.st_code_for_prn,
            num_prn=glonass.NUM_FREQ_CH,
            bit_len_codes=10,
            fdma_zero_prn=8,
        )
    )


_register_builtin()
