"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936, qk-norm.  [hf:Qwen/Qwen3-8B; hf]

head_dim=128 per the Qwen3 family (decoupled from d_model/num_heads).
"""
from repro_torch.models.config import ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    pattern=uniform_pattern(),
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen3-0.6b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=192,
    vocab_size=256,
    pattern=uniform_pattern(),
    qk_norm=True,
    tie_embeddings=True,
    dtype="float32",
)
