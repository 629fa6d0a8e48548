"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192,
ssm_state=64 — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf]

One shared attention+MLP block (a single parameter set) is invoked after
every 6 Mamba2 layers (zamba's weight-shared global block).  sub-quadratic
(Mamba2 state is O(1); shared-attn decode is linear in cache) -> long_500k.
"""
from repro_torch.models.config import AttnSpec, ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32_000,
    attn=AttnSpec(pattern=("global",), rope_theta=10_000.0),
    ssm=SSMSpec(state_dim=64, head_dim=64, expand=2, conv_width=4, chunk=128),
    shared_attn_every=6,
    act="gelu", tie_embeddings=True, sub_quadratic=True,
)

REDUCED = ModelConfig(
    name="zamba2-1.2b-reduced", family="hybrid",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    attn=AttnSpec(pattern=("global",), rope_theta=10_000.0),
    ssm=SSMSpec(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=8),
    shared_attn_every=2,
    act="gelu", tie_embeddings=True, sub_quadratic=True,
)
