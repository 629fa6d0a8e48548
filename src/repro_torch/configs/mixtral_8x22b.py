"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA [arXiv:2401.04088; hf]

long_500k eligible: the assigned config specifies sliding-window attention,
so decode state is a rolling window (sub-quadratic).
"""
from repro_torch.models.config import AttnSpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32_768,
    attn=AttnSpec(pattern=("local",), window=4096, rope_theta=1_000_000.0),
    moe=MoESpec(num_experts=8, top_k=2, d_expert=16384),
    act="silu", tie_embeddings=False, sub_quadratic=True,
)

REDUCED = ModelConfig(
    name="mixtral-8x22b-reduced", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=512,
    attn=AttnSpec(pattern=("local",), window=16, rope_theta=1_000_000.0),
    moe=MoESpec(num_experts=4, top_k=2, d_expert=96),
    act="silu", tie_embeddings=False, sub_quadratic=True,
)
