"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global, 128k context [hf:google/gemma-3; unverified]
"""
from repro_torch.models.config import AttnSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=10240, vocab_size=262_144,
    attn=AttnSpec(pattern=("local",) * 5 + ("global",), window=1024,
                  qk_norm=True, rope_theta=1_000_000.0,
                  rope_theta_local=10_000.0),
    post_norms=True, embed_scale=True, act="gelu", tie_embeddings=True,
    sub_quadratic=False,
)

REDUCED = ModelConfig(
    name="gemma3-4b-reduced", family="dense",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    attn=AttnSpec(pattern=("local",) * 2 + ("global",), window=16,
                  qk_norm=True, rope_theta=1_000_000.0,
                  rope_theta_local=10_000.0),
    post_norms=True, embed_scale=True, act="gelu", tie_embeddings=True,
)
