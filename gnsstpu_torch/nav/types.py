"""Navigation data types.

Copied from gnsstpu/nav/types.py; only the import prefix differs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Ephemeris:
    """GPS LNAV broadcast ephemeris (fields as in IS-GPS-200 / the
    reference decoder GPS/L1/include/ephemeris.sci:71-228)."""

    # Subframe 1
    week: int = 0
    accuracy: int = 0
    health: int = 0
    T_GD: float = 0.0
    IODC: int = 0
    t_oc: float = 0.0
    a_f2: float = 0.0
    a_f1: float = 0.0
    a_f0: float = 0.0
    # Subframe 2
    IODE_sf2: int = 0
    C_rs: float = 0.0
    deltan: float = 0.0
    M_0: float = 0.0
    C_uc: float = 0.0
    e: float = 0.0
    C_us: float = 0.0
    sqrtA: float = 0.0
    t_oe: float = 0.0
    # Subframe 3
    C_ic: float = 0.0
    omega_0: float = 0.0
    C_is: float = 0.0
    i_0: float = 0.0
    C_rc: float = 0.0
    omega: float = 0.0
    omegaDot: float = 0.0
    IODE_sf3: int = 0
    iDot: float = 0.0
    # Set by the decoder once subframes 1-3 have all passed parity.
    valid: bool = False
