"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE, dynamic resolution [arXiv:2409.12191; hf]

Backbone only; the vision tower is a stub — input_specs() provides
precomputed patch embeddings merged into the token sequence.
"""
from repro_torch.models.config import AttnSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152_064,
    attn=AttnSpec(pattern=("global",), qkv_bias=True,
                  rope_theta=1_000_000.0),
    mrope=True, mrope_sections=(16, 24, 24),
    act="silu", tie_embeddings=False, sub_quadratic=False,
)

REDUCED = ModelConfig(
    name="qwen2-vl-7b-reduced", family="vlm",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    attn=AttnSpec(pattern=("global",), qkv_bias=True,
                  rope_theta=1_000_000.0),
    mrope=True, mrope_sections=(2, 3, 3),
    act="silu", tie_embeddings=False,
)
