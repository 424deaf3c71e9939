"""Config dataclasses: model architectures and the paper's FL knobs.

The port's copy of ``repro.configs.base``: ``ModelConfig`` with
``reduced`` (the CPU-smoke variant of a family) and the protocol
dataclasses.  The input-shape and run configs belong to the launch
path, which is not ported yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description consumed by ``repro_torch.models``.

    Only the transformer/SSM backbone is described; modality frontends
    (audio conv stack, ViT) are stubs per the assignment carve-out.
    """

    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm

    n_layers: int
    d_model: int
    vocab_size: int

    # Attention (unused for family == "ssm")
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_softcap: Optional[float] = None       # gemma2 / grok soft-capping
    sliding_window: Optional[int] = None       # window size for local layers
    local_global_period: Optional[int] = None  # e.g. 2 => alternate local/global
    global_layers: Tuple[int, ...] = ()        # explicit global-attn layers (hymba)

    # MLP
    d_ff: int = 0
    activation: str = "silu"                   # silu (swiglu) | geglu | gelu
    mlp_bias: bool = False

    # Output
    logit_softcap: Optional[float] = None
    tie_embeddings: bool = False

    # Norm
    norm: str = "rmsnorm"                      # rmsnorm | layernorm
    norm_eps: float = 1e-6
    post_attn_norm: bool = False               # gemma2 style post-norms
    embed_scale: bool = False                  # gemma multiplies embeds by sqrt(d)

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                          # per-expert hidden dim
    router_aux_coef: float = 0.01

    # SSM (mamba2 SSD) — also used by hybrid heads
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128

    # Encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_seq_len: int = 0                   # frame embeddings from the stub
    cross_attention: bool = False

    # VLM (chameleon) — early fusion, VQ image tokens share the vocab
    image_token_span: int = 0                  # tokens per image (stub metadata)

    source: str = ""                           # citation, e.g. [arXiv:xxxx]

    # ---- derived -----------------------------------------------------------
    @property
    def d_head_total(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    def layer_is_local(self, layer_idx: int) -> bool:
        """True if layer uses sliding-window attention."""
        if self.sliding_window is None:
            return False
        if self.global_layers:
            return layer_idx not in self.global_layers
        if self.local_global_period:
            # gemma2 pattern: local first, then global (local on even idx)
            return (layer_idx % self.local_global_period) != (
                self.local_global_period - 1)
        return True

    def supports_long_context(self) -> bool:
        """Sub-quadratic decode => eligible for long_500k."""
        if self.family in ("ssm", "hybrid"):
            return True
        # dense archs qualify only with a sliding-window variant
        return self.sliding_window is not None

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + backbone)."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d            # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d        # unembed
        per_layer = 0
        if self.family != "ssm":
            q = self.n_heads * self.head_dim
            kv = self.n_kv_heads * self.head_dim
            per_layer += d * q + 2 * d * kv + q * d   # qkvo
            if self.qkv_bias:
                per_layer += q + 2 * kv
        if self.family in ("ssm", "hybrid"):
            di = self.ssm_d_inner
            per_layer += d * (2 * di + 2 * self.ssm_n_heads * self.ssm_state) \
                + di * d + di * self.ssm_conv_width + 2 * self.ssm_n_heads
        if self.n_experts:
            per_layer += self.n_experts * 3 * d * self.moe_d_ff
            per_layer += self.n_shared_experts * 3 * d * self.moe_d_ff
            per_layer += d * self.n_experts  # router
        elif self.d_ff:
            mult = 3 if self.activation in ("silu", "geglu") else 2
            per_layer += mult * d * self.d_ff
        per_layer += 2 * d                   # norms
        n += self.n_layers * per_layer
        if self.cross_attention:
            q = self.n_heads * self.head_dim
            kv = self.n_kv_heads * self.head_dim
            n += self.n_layers * (d * q + 2 * d * kv + q * d)
            # encoder stack
            enc_per = 4 * d * self.head_dim * self.n_heads + 2 * d * self.d_ff
            n += self.n_encoder_layers * enc_per
        return n


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
            vocab: int = 512) -> ModelConfig:
    """Reduced variant of the same family for CPU smoke tests."""
    d_model = min(cfg.d_model, d_model)
    head_dim = 32
    n_heads = max(2, min(4, cfg.n_heads)) if cfg.n_heads else 0
    n_kv = max(1, min(n_heads, max(1, cfg.n_kv_heads * n_heads
                                   // max(cfg.n_heads, 1)))) if n_heads else 0
    upd = dict(
        n_layers=min(cfg.n_layers, n_layers),
        d_model=d_model,
        vocab_size=min(cfg.vocab_size, vocab),
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim if n_heads else 0,
        d_ff=min(cfg.d_ff, 4 * d_model) if cfg.d_ff else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssm_chunk=32,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        moe_d_ff=min(cfg.moe_d_ff, 2 * d_model) if cfg.moe_d_ff else 0,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_seq_len=min(cfg.encoder_seq_len, 64) if cfg.encoder_seq_len else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
        global_layers=tuple(g for g in cfg.global_layers if g < n_layers) or (
            (0,) if cfg.global_layers else ()),
    )
    return dataclasses.replace(cfg, **upd)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# FL protocol configuration (the paper's knobs)
# ---------------------------------------------------------------------------


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
    engine: str = "event"         # event (core/simulator.py, the
    #                               default, as in the reference) |
    #                               cohort (cohort/engine.py, host tick
    #                               loop) | device (cohort/device.py)
    cohort_block: int = 64        # iteration credit per cohort tick
    scenario: Optional[Any] = None     # scenario preset name or Scenario
    aggregation: Optional[Any] = None  # strategy spec (paper/fedasync/fedbuff)


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    fl: FLConfig = field(default_factory=FLConfig)
    shape: str = "train_4k"
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    use_pallas: bool = False      # the reference's kernel switch: kept
    #                               for its field set, read by nothing
