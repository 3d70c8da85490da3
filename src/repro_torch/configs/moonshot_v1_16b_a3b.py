"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (GQA kv=16, i.e. MHA)
d_ff=1408 (per expert) vocab=163840, MoE 64e top-6 (kimi/moonlight).
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.models.config import ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    pattern=uniform_pattern(moe=True),
    num_experts=64,
    num_experts_per_tok=6,
    rope_theta=50_000.0,
)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=96,
    vocab_size=512,
    pattern=uniform_pattern(moe=True),
    num_experts=8,
    num_experts_per_tok=2,
    dtype="float32",
)
