"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) per-expert d_ff=1408,
vocab=151936, 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=0,
        vocab_size=151936,
        qkv_bias=True,
        activation="silu",
        norm="rmsnorm",
        n_experts=60,
        n_shared_experts=4,
        moe_top_k=4,
        moe_d_ff=1408,
        router_aux_coef=0.001,
        source="[hf:Qwen/Qwen1.5-MoE-A2.7B]",
    )
