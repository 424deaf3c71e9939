"""PRNG salts of the key chains the port reproduces, and their registry.

The values are the reference's (``repro/analysis/salts.py``); a chain
keyed off ``seed ^ SALT`` must use the same salt in both packages or
the draws no longer line up.

The registry is the single source of truth for every ``PRNGKey(seed ^
SALT)`` / ``default_rng(seed ^ SALT)`` root in the port: each salt with
its chain semantics and the modules allowed to key-create with it.
``repro_torch.analysis.prng`` fails the lint on an XOR-salted key
creation whose salt is not imported from here, on a salt key-created
outside its declared sites, and on a numeric collision between salts.
Two chains keyed off one ``seed ^ salt`` root would draw correlated
randomness, and the fault would show only as an odd trajectory.  One
chain may have two roots: the DP-noise chain is keyed identically by
both cohort engines because their parity needs the same noise.

Declaring a salt: add the constant, then

    _declare("MY_SALT", MY_SALT, chain="what the chain draws",
             sites=("repro_torch.my.module",))

and import it at the use site (``from repro_torch.analysis.salts import
MY_SALT``).  The engines import this module, so it stays stdlib only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

# message-addressed latency draws: update by (client, round), broadcast
# by (k, client) on fold_in branches 0/1
LAT_SALT = 0x1A7E9C
# drawn per-client latency-table assignments: per-client fold_in
# uniforms inverted through the weight CDF
TABLE_SALT = 0x7AB1E
# availability churn: per-(epoch, client) uniforms for Churn and the
# client factor of RegionalChurn
AVAIL_SALT = 0xA7A1B
# numpy stream for diurnal per-client phase draws
PHASE_SALT = 0xD1A7
# regional-churn shared factor: per-(epoch, region) up-draws
REGION_SALT = 0x2E610
# renewal churn: per-(epoch, client) holding-time draws
RENEW_SALT = 0x9E4A1
# numpy stream for the per-client fleet speed draw (SpeedModel.draw)
SPEED_SALT = 0x5BEED
# round-completion DP noise: fold_in(PRNGKey(seed ^ NOISE_SALT), tick)
NOISE_SALT = 0x5EED


@dataclass(frozen=True)
class Salt:
    name: str
    value: int
    chain: str                 # what the derived key chain draws
    sites: Tuple[str, ...]     # modules allowed to key-create with it


REGISTRY: Dict[str, Salt] = {}


def _declare(name: str, value: int, *, chain: str,
             sites: Tuple[str, ...]) -> int:
    if name in REGISTRY:
        raise ValueError(f"salt {name} declared twice")
    REGISTRY[name] = Salt(name, int(value), chain, tuple(sites))
    return int(value)


# -- scenario chains (repro_torch.scenarios) ---------------------------------
_declare(
    "LAT_SALT", LAT_SALT,
    chain="message-addressed latency draws: update by (client, round), "
          "broadcast by (k, client) on fold_in branches 0/1",
    sites=("repro_torch.scenarios.registry",))
_declare(
    "TABLE_SALT", TABLE_SALT,
    chain="drawn per-client latency-table assignments: per-client "
          "fold_in uniforms inverted through the weight CDF "
          "(draw_table_ids, jit-rederivable on every host)",
    sites=("repro_torch.scenarios.registry",))
_declare(
    "AVAIL_SALT", AVAIL_SALT,
    chain="availability churn: per-(epoch, client) uniforms for Churn "
          "and the client factor of RegionalChurn",
    sites=("repro_torch.scenarios.availability",))
_declare(
    "PHASE_SALT", PHASE_SALT,
    chain="numpy stream for diurnal per-client phase draws",
    sites=("repro_torch.scenarios.availability",))
_declare(
    "REGION_SALT", REGION_SALT,
    chain="regional-churn shared factor: per-(epoch, region) up-draws",
    sites=("repro_torch.scenarios.availability",))
_declare(
    "RENEW_SALT", RENEW_SALT,
    chain="renewal churn: per-(epoch, client) holding-time draws "
          "(_renewal_epoch_draw), consumed by BOTH the cohort tick "
          "masks and the event sim's renewal windows (path-wise "
          "alignment)",
    sites=("repro_torch.scenarios.availability",))
_declare(
    "SPEED_SALT", SPEED_SALT,
    chain="numpy stream for the per-client fleet speed draw "
          "(SpeedModel.draw)",
    sites=("repro_torch.scenarios.availability",))

# -- DP chain (repro_torch.cohort) -------------------------------------------
# ONE chain, keyed from two modules by design: the host and device
# engines must fold the SAME per-tick noise keys or their bit parity
# breaks.
_declare(
    "NOISE_SALT", NOISE_SALT,
    chain="round-completion DP noise: fold_in(PRNGKey(seed ^ NOISE_SALT), "
          "tick), shared verbatim by both cohort engines (parity)",
    sites=("repro_torch.cohort.engine", "repro_torch.cohort.device"))


def salt_names() -> List[str]:
    return sorted(REGISTRY)


def check_registry() -> List["Violation"]:  # noqa: F821 (doc type)
    """Registry self-audit: numeric collisions between declared salts.

    (Exact collisions only: distinct salts land in distinct threefry
    key spaces even at hamming distance 1, so near-misses are fine.)
    """
    from repro_torch.analysis.base import Violation
    out: List[Violation] = []
    by_value: Dict[int, List[str]] = {}
    for s in REGISTRY.values():
        by_value.setdefault(s.value, []).append(s.name)
    for value, names in sorted(by_value.items()):
        if len(names) > 1:
            out.append(Violation(
                "PRNG-COLLISION", "<registry>", 0,
                f"salts {sorted(names)} share value {value:#x}"))
    return out
