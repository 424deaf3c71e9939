"""mamba2-780m [ssm] — 48L d_model=1536 attention-free, vocab=50280,
ssm_state=128; SSD (state-space duality).  [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_conv_width=4,
        ssm_chunk=128,
        norm="rmsnorm",
        tie_embeddings=True,
        source="[arXiv:2405.21060]",
    )
