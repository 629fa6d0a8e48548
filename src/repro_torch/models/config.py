"""Architecture configuration dataclasses covering all assigned families."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Attention behaviour; ``pattern`` is the repeating per-layer cycle."""
    pattern: Tuple[str, ...] = ("global",)   # entries: 'global' | 'local'
    window: int = 0                          # local / sliding-window size
    softcap: float = 0.0                     # attn logit softcap (gemma2)
    qk_norm: bool = False                    # RMSNorm on q,k (gemma3)
    qkv_bias: bool = False                   # qwen2
    rope: bool = True                        # whisper: absolute pos, no rope
    rope_theta: float = 10_000.0
    rope_theta_local: Optional[float] = None  # gemma3 local layers


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_expert: int                            # expert hidden dim
    num_shared: int = 0                      # shared experts (deepseek)
    capacity_factor: float = 1.25
    dense_first_n: int = 0                   # leading dense-FFN layers
    d_ff_dense: int = 0                      # their hidden dim
    router_aux_coef: float = 0.01            # load-balance loss weight


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    state_dim: int = 64                      # N
    head_dim: int = 64                       # P
    expand: int = 2                          # inner = expand * d_model
    conv_width: int = 4
    n_groups: int = 1
    chunk: int = 128                         # SSD chunk length


@dataclasses.dataclass(frozen=True)
class RWKVSpec:
    head_dim: int = 64
    decay_lora: int = 64
    gate_lora: int = 64
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | ssm | audio | hybrid
    num_layers: int              # decoder layers for enc-dec
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    attn: AttnSpec = AttnSpec()
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    rwkv: Optional[RWKVSpec] = None
    # enc-dec (whisper): encoder_layers > 0 makes the model encoder-decoder
    encoder_layers: int = 0
    max_source_positions: int = 1500
    # zamba2: a single shared attention block invoked every k SSM layers
    shared_attn_every: int = 0
    # gemma family
    final_logit_softcap: float = 0.0
    post_norms: bool = False                 # sandwich norms (gemma2/3)
    # qwen2-vl
    mrope: bool = False
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # t/h/w splits of head_dim/2
    # misc
    embed_scale: bool = False                # gemma: embeddings * sqrt(d)
    max_target_positions: int = 0            # whisper learned dec pos table
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"                        # silu (SwiGLU) | gelu (GeGLU)
    dtype: str = "bfloat16"
    # long_500k eligibility (sub-quadratic decode state)
    sub_quadratic: bool = False
    # which step kinds exist for this arch
    has_decode: bool = True

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind list for the decoder-side stack."""
        if self.family == "ssm" and self.rwkv is not None:
            return tuple("rwkv" for _ in range(self.num_layers))
        if self.family in ("ssm", "hybrid") and self.ssm is not None:
            return tuple("mamba" for _ in range(self.num_layers))
        cyc = self.attn.pattern
        return tuple(cyc[i % len(cyc)] for i in range(self.num_layers))

    def param_count_estimate(self) -> int:
        """Rough parameter count (for roofline MODEL_FLOPS)."""
        d, l = self.d_model, self.num_layers
        qkv = d * self.head_dim * (self.num_heads + 2 * self.num_kv_heads)
        proj = self.num_heads * self.head_dim * d
        attn = qkv + proj
        if self.moe is not None:
            dense_ffn = 3 * d * self.moe.d_ff_dense * self.moe.dense_first_n
            moe_l = l - self.moe.dense_first_n
            ffn = moe_l * 3 * d * self.moe.d_expert * (
                self.moe.num_experts + self.moe.num_shared) + dense_ffn
            ffn += moe_l * d * self.moe.num_experts      # router
            attn_total = l * attn
        elif self.family == "ssm" and self.rwkv is not None:
            inner = d
            ffn = l * 2 * d * self.d_ff
            attn_total = l * (4 * d * inner + inner * d)
        elif self.ssm is not None:
            inner = self.ssm.expand * d
            nheads = inner // self.ssm.head_dim
            per = d * (2 * inner + 2 * self.ssm.n_groups * self.ssm.state_dim
                       + nheads) + inner * d
            attn_total = l * per
            ffn = 0
            if self.shared_attn_every:
                # weight-shared block: counted per *invocation* — this
                # estimate feeds MODEL_FLOPS (execution view), not bytes
                invocations = l // self.shared_attn_every
                ffn += invocations * (attn + 3 * d * self.d_ff)
        else:
            ffn = l * 3 * d * self.d_ff
            attn_total = l * attn
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        enc = 0
        if self.is_encdec:
            enc = self.encoder_layers * (attn + 3 * d * self.d_ff)
            attn_total += l * attn           # cross attention
        return attn_total + ffn + embed + enc

    def active_param_count_estimate(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count_estimate()
        d, l = self.d_model, self.num_layers
        moe_l = l - self.moe.dense_first_n
        total = self.param_count_estimate()
        all_experts = moe_l * 3 * d * self.moe.d_expert * self.moe.num_experts
        active = moe_l * 3 * d * self.moe.d_expert * self.moe.top_k
        return total - all_experts + active
