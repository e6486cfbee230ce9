"""TXL-ACAM device configuration (paper §III).

Only the `ACAMConfig` value type is ported so far: `EngineConfig.device` and
the service spec's JSON carry it. The behavioural device models (program,
sense, calibration) and the device backend come with the device-physics
slice of the port.
"""
from __future__ import annotations

from typing import NamedTuple


class ACAMConfig(NamedTuple):
    cell: str = "6T4R"  # or "3T1R"
    vdd: float = 1.8  # 180 nm CMOS supply
    # matchline dynamics
    c_ml: float = 20e-15  # matchline capacitance [F]
    i_cell: float = 2e-6  # per-cell current-limited charge current [A]
    t_eval: float = 10e-9  # evaluation window [s]
    sense_frac: float = 0.5  # sense-amp threshold as fraction of VDD
    # RRAM programming
    sigma_program: float = 0.0  # log-normal sigma on window edges
    #: calibrate I_cell so a full-row match charges exactly to VDD within
    #: t_eval (§III-B)
    auto_calibrate: bool = True
    # energy
    e_cell: float = 185e-15  # J per similarity-search op per cell (§III-B)
    # differentiable surrogate sharpness
    beta: float = 25.0
