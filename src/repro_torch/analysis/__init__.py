"""Static analysis of the port and checks of its traces.

Rule families (see ``python -m repro_torch.analysis --help``):
  PRNG-*    — PRNG address-space audit against the central salt
              registry (``repro_torch.analysis.salts``)
  PURITY-*  — host-world constructs inside what torch traces or re-runs
              (``repro_torch.analysis.purity``)
  STRUCT-*  — spec coverage and dtype discipline of ``DeviceCohortState``
  INV-*     — protocol invariants model-checked over JSONL telemetry
              traces (``repro_torch.analysis.invariants``)

Only the salt registry is imported eagerly: the engines import their
salts from here at module-import time, so this package must not pull
in the engine packages (keep this __init__ free of runner/structure
imports).
"""
from repro_torch.analysis.base import Violation
from repro_torch.analysis.salts import (AVAIL_SALT, LAT_SALT, NOISE_SALT,
                                        PHASE_SALT, REGION_SALT, RENEW_SALT,
                                        SPEED_SALT, TABLE_SALT, REGISTRY,
                                        Salt, salt_names)

__all__ = [
    "Violation", "Salt", "REGISTRY", "salt_names",
    "LAT_SALT", "TABLE_SALT", "AVAIL_SALT", "PHASE_SALT", "REGION_SALT",
    "RENEW_SALT", "SPEED_SALT", "NOISE_SALT",
]
