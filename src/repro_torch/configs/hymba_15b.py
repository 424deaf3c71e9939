"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504,
vocab=32001, ssm_state=16; parallel attention+mamba heads in each layer;
sliding window on all but 3 global layers (first/middle/last).
[arXiv:2411.13676]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        activation="silu",
        norm="rmsnorm",
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_conv_width=4,
        ssm_chunk=128,
        sliding_window=1024,
        global_layers=(0, 15, 31),
        source="[arXiv:2411.13676]",
    )
