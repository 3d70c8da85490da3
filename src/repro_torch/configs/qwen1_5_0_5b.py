"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (MHA kv=16) d_ff=2816
vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.models.config import ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    pattern=uniform_pattern(),
    qkv_bias=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen1.5-0.5b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=192,
    vocab_size=256,
    pattern=uniform_pattern(),
    qkv_bias=True,
    tie_embeddings=True,
    dtype="float32",
)
