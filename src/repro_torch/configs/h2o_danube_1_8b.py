"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]

SWA window 4096 makes it sub-quadratic -> runs long_500k (ring-buffer KV
cache of window size).
"""
from repro_torch.models.config import ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    pattern=uniform_pattern(),
    sliding_window=4096,
)

SMOKE = ModelConfig(
    name="h2o-danube-1.8b-smoke",
    num_layers=2,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=256,
    pattern=uniform_pattern(),
    sliding_window=8,
    dtype="float32",
)
