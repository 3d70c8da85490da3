"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, QKV bias.  [arXiv:2407.10671; hf]
"""
from repro_torch.models.config import ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    pattern=uniform_pattern(),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-1.5b-smoke",
    num_layers=2,
    d_model=96,
    num_heads=6,
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=256,
    pattern=uniform_pattern(),
    qkv_bias=True,
    tie_embeddings=True,
    dtype="float32",
)
