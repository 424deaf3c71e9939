"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000;
local+global alternating sliding window, logit softcap.  [arXiv:2408.00118]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        activation="geglu",
        norm="rmsnorm",
        post_attn_norm=True,
        embed_scale=True,
        sliding_window=4096,
        local_global_period=2,   # alternate local/global
        attn_softcap=50.0,
        logit_softcap=30.0,
        tie_embeddings=True,
        source="[arXiv:2408.00118]",
    )
