"""FL protocol configuration: the paper's knobs.

The port's copy of the protocol dataclasses of ``repro.configs.base``
(the architecture and input-shape configs belong to the model-scale
path, which is not ported yet).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class SampleSequenceConfig:
    """Sample-size sequence s_i.

    kinds:
      constant:   s_i = s0
      linear:     s_i = s0 + ceil(a * i)                     (Θ(i), paper E.2.2)
      power:      s_i = ceil(N_c * q * (i + m)^p)            (Theorem 4 form)
      ilog:       s_i = ceil((m+i+1)/(16 (d+1)^2 ln((m+i+1)/(2(d+1)))))  (Thm 5)
    """
    kind: str = "linear"
    s0: int = 16
    a: float = 1.0
    p: float = 1.0
    m: float = 0.0
    q: float = 0.0
    N_c: int = 0
    d: int = 1  # permissible-delay slack (condition (3))


@dataclass(frozen=True)
class StepSizeConfig:
    """eta_t schemes from the paper's experiments + Lemma 2 round transform.

    kinds: constant | inv_t (eta0/(1+beta t)) | inv_sqrt (eta0/(1+beta sqrt t))
           | theorem5 (12/(mu (t + E_t)))
    round_transform: use round step sizes eta_bar_i = eta_{t(i)} (diminishing_2)
    """
    kind: str = "inv_t"
    eta0: float = 0.1
    beta: float = 0.001
    mu: float = 0.0
    round_transform: bool = True


@dataclass(frozen=True)
class DPConfig:
    enabled: bool = False
    clip_norm: float = 0.1
    sigma: float = 8.0
    granularity: str = "example"  # example | client
    delta: float = 1e-6
    epsilon: float = 0.0          # target (0 => derived)


@dataclass(frozen=True)
class FLConfig:
    n_clients: int = 5
    client_weights: Optional[Tuple[float, ...]] = None  # p_c, default uniform
    sample_seq: SampleSequenceConfig = field(default_factory=SampleSequenceConfig)
    step_size: StepSizeConfig = field(default_factory=StepSizeConfig)
    dp: DPConfig = field(default_factory=DPConfig)
    d: int = 1                    # gate i <= k + d
    total_grads: int = 20_000     # K
    seed: int = 0
    engine: str = "device"        # the port runs the device engine only
    cohort_block: int = 64        # iteration credit per cohort tick
    scenario: Optional[Any] = None     # scenario preset name or Scenario
    aggregation: Optional[Any] = None  # strategy spec (paper/fedasync/fedbuff)
