"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2, Mamba+attention 1:7 interleave.
[arXiv:2403.19887; hf]

Pattern: period-8 super-block (attention at index 4, Mamba elsewhere; MoE
on every other sub-layer), repeated 9 times = 72 layers.  Runs long_500k
(sub-quadratic: 9 attention layers with cache + O(1) SSM states).
"""
from repro_torch.models.config import ModelConfig, jamba_pattern

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=jamba_pattern(),
    num_experts=16,
    num_experts_per_tok=2,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
)

SMOKE = ModelConfig(
    name="jamba-1.5-large-398b-smoke",
    num_layers=8,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    pattern=jamba_pattern(),
    num_experts=4,
    num_experts_per_tok=2,
    ssm_state=8,
    dtype="float32",
)
