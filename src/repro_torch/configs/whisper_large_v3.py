"""whisper-large-v3 [audio] — 32L decoder, d_model=1280 20H (kv=20) d_ff=5120
vocab=51866; encoder-decoder with conv/mel frontend STUB (input_specs provides
precomputed frame embeddings).  [arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-large-v3",
        family="encdec",
        n_layers=32,             # decoder layers
        n_encoder_layers=32,
        encoder_seq_len=1500,    # mel frames after conv stub
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab_size=51866,
        qkv_bias=True,           # whisper uses biases
        mlp_bias=True,
        activation="gelu",
        norm="layernorm",
        norm_eps=1e-5,
        cross_attention=True,
        rope_theta=0.0,          # whisper uses learned positions; we use sinusoidal stub
        source="[arXiv:2212.04356]",
    )
