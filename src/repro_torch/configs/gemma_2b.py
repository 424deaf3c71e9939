"""gemma-2b [dense] — 18L d_model=2048 8H head_dim=256 (MQA kv=1)
d_ff=16384 vocab=256000; GeGLU.  [arXiv:2403.08295]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="gemma-2b",
        family="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        activation="geglu",
        norm="rmsnorm",
        embed_scale=True,
        tie_embeddings=True,
        source="[arXiv:2403.08295]",
    )
