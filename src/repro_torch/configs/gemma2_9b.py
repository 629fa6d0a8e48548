"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local+global alternating, logit softcap [arXiv:2408.00118; hf]
"""
from repro_torch.models.config import AttnSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256_000,
    attn=AttnSpec(pattern=("local", "global"), window=4096, softcap=50.0,
                  rope_theta=10_000.0),
    final_logit_softcap=30.0, post_norms=True, embed_scale=True,
    act="gelu", tie_embeddings=True, sub_quadratic=False,
)

REDUCED = ModelConfig(
    name="gemma2-9b-reduced", family="dense",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    attn=AttnSpec(pattern=("local", "global"), window=16, softcap=50.0,
                  rope_theta=10_000.0),
    final_logit_softcap=30.0, post_norms=True, embed_scale=True,
    act="gelu", tie_embeddings=True,
)
