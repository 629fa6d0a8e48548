"""yi-6b [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 —
llama-arch GQA [arXiv:2403.04652; hf]
"""
from repro_torch.models.config import AttnSpec, ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64_000,
    attn=AttnSpec(pattern=("global",), rope_theta=5_000_000.0),
    act="silu", tie_embeddings=False, sub_quadratic=False,
)

REDUCED = ModelConfig(
    name="yi-6b-reduced", family="dense",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    attn=AttnSpec(pattern=("global",), rope_theta=5_000_000.0),
    act="silu", tie_embeddings=False,
)
