"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 — GQA 128k vocab [arXiv:2407.21783]
"""
from repro_torch.models.config import AttnSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    head_dim=128, d_ff=53248, vocab_size=128_256,
    attn=AttnSpec(pattern=("global",), rope_theta=500_000.0),
    act="silu", tie_embeddings=False, sub_quadratic=False,
)

REDUCED = ModelConfig(
    name="llama3-405b-reduced", family="dense",
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=160, vocab_size=512,
    attn=AttnSpec(pattern=("global",), rope_theta=500_000.0),
    act="silu", tie_embeddings=False,
)
