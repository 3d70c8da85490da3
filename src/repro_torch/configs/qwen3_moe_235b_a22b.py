"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
(per expert) vocab=151936, MoE 128e top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]

head_dim=128 and qk-norm per the Qwen3 family definition.
"""
from repro_torch.models.config import ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    pattern=uniform_pattern(moe=True),
    num_experts=128,
    num_experts_per_tok=8,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-moe-235b-a22b-smoke",
    num_layers=2,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    head_dim=32,
    d_ff=96,
    vocab_size=512,
    pattern=uniform_pattern(moe=True),
    num_experts=8,
    num_experts_per_tok=2,
    qk_norm=True,
    dtype="float32",
)
