"""whisper-medium [audio]: 24L d_model=1024 16H (kv=16, i.e. MHA) d_ff=4096
vocab=51865 — enc-dec, conv frontend (stub) [arXiv:2212.04356]

Adaptations (DESIGN.md): the conv/mel frontend is a stub — input_specs()
provides precomputed frame embeddings [B, frames, d_model]; the learned
decoder position table is extended to 32768 (real model: 448) so the
assigned decode_32k stress shape is exercisable; absolute positions, no
RoPE.  long_500k skipped (full-attention decoder).
"""
from repro_torch.models.config import AttnSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    num_layers=24, encoder_layers=24,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51_865,
    attn=AttnSpec(pattern=("global",), rope=False, qkv_bias=True),
    max_source_positions=1500, max_target_positions=32_768,
    act="gelu", tie_embeddings=True, sub_quadratic=False,
)

REDUCED = ModelConfig(
    name="whisper-medium-reduced", family="audio",
    num_layers=2, encoder_layers=2,
    d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    attn=AttnSpec(pattern=("global",), rope=False, qkv_bias=True),
    max_source_positions=32, max_target_positions=64,
    act="gelu", tie_embeddings=True,
)
