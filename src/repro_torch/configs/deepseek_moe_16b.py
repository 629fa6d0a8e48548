"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64 routed top-6 + 2 shared, fine-grained; first layer is a
dense FFN (d_ff 10944) [arXiv:2401.06066; hf]
"""
from repro_torch.models.config import AttnSpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102_400,
    attn=AttnSpec(pattern=("global",), rope_theta=10_000.0),
    moe=MoESpec(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                dense_first_n=1, d_ff_dense=10944),
    act="silu", tie_embeddings=False, sub_quadratic=False,
)

REDUCED = ModelConfig(
    name="deepseek-moe-16b-reduced", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=32, vocab_size=512,
    attn=AttnSpec(pattern=("global",), rope_theta=10_000.0),
    moe=MoESpec(num_experts=8, top_k=2, d_expert=32, num_shared=1,
                dense_first_n=1, d_ff_dense=128),
    act="silu", tie_embeddings=False,
)
