"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, 8 experts top-2.  [hf:xai-org/grok-1]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=0,
        vocab_size=131072,
        activation="gelu",
        norm="rmsnorm",
        attn_softcap=30.0,
        logit_softcap=30.0,
        n_experts=8,
        n_shared_experts=0,
        moe_top_k=2,
        moe_d_ff=32768,
        router_aux_coef=0.001,
        source="[hf:xai-org/grok-1]",
    )
