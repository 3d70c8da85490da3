"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000, anyres tiling.  [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified]

Backbone only (Yi-34B-class decoder); the anyres vision tower is a STUB:
``input_specs`` supplies precomputed patch embeddings [B, P, D] with
P = 576 (one 24x24 base grid) prepended to the text tokens.
"""
from repro_torch.models.config import ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="llava-next-34b",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    pattern=uniform_pattern(),
    rope_theta=5_000_000.0,
    vision_tokens=576,
)

SMOKE = ModelConfig(
    name="llava-next-34b-smoke",
    num_layers=2,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=256,
    pattern=uniform_pattern(),
    vision_tokens=8,
    dtype="float32",
)
