"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
Early fusion: VQ image tokens share the text vocabulary, so the frontend stub
is the VQ tokenizer — input_specs provides interleaved discrete tokens plus a
modality mask.  [arXiv:2405.09818]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=65536,
        activation="silu",
        norm="rmsnorm",
        rope_theta=10_000.0,
        image_token_span=1024,   # VQ tokens per image (stub metadata)
        source="[arXiv:2405.09818]",
    )
