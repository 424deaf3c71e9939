"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs.base import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str, fn: Callable[[], ModelConfig]) -> None:
    _REGISTRY[arch_id] = fn


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs():
    return sorted(_REGISTRY)


def _populate() -> None:
    from repro_torch.configs import (chameleon_34b, gemma2_2b, gemma_2b,
                                     grok1_314b, hymba_15b, mamba2_780m,
                                     minitron_8b, paper_logreg, qwen15_32b,
                                     qwen2_moe_a27b, whisper_large_v3)
    register("qwen1.5-32b", qwen15_32b.config)
    register("whisper-large-v3", whisper_large_v3.config)
    register("chameleon-34b", chameleon_34b.config)
    register("mamba2-780m", mamba2_780m.config)
    register("gemma2-2b", gemma2_2b.config)
    register("hymba-1.5b", hymba_15b.config)
    register("gemma-2b", gemma_2b.config)
    register("minitron-8b", minitron_8b.config)
    register("qwen2-moe-a2.7b", qwen2_moe_a27b.config)
    register("grok-1-314b", grok1_314b.config)
    register("paper-logreg", paper_logreg.config)


_populate()

ASSIGNED_ARCHS = [
    "qwen1.5-32b", "whisper-large-v3", "chameleon-34b", "mamba2-780m",
    "gemma2-2b", "hymba-1.5b", "gemma-2b", "minitron-8b",
    "qwen2-moe-a2.7b", "grok-1-314b",
]
