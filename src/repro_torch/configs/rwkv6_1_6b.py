"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536 —
Finch, data-dependent decay [arXiv:2404.05892]

sub-quadratic: O(1) recurrent state -> runs long_500k.
"""
from repro_torch.models.config import AttnSpec, ModelConfig, RWKVSpec

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=7168, vocab_size=65_536,
    attn=AttnSpec(pattern=("global",)),      # unused (attn-free)
    rwkv=RWKVSpec(head_dim=64, decay_lora=64, gate_lora=32, chunk=128),
    act="silu", tie_embeddings=False, sub_quadratic=True,
)

REDUCED = ModelConfig(
    name="rwkv6-1.6b-reduced", family="ssm",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    attn=AttnSpec(pattern=("global",)),
    rwkv=RWKVSpec(head_dim=16, decay_lora=8, gate_lora=8, chunk=8),
    act="silu", tie_embeddings=False, sub_quadratic=True,
)
