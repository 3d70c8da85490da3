"""falcon-mamba-7b [ssm] — 64L d_model=4096 attention-free d_ff=0
vocab=65024, ssm_state=16, Mamba-1 architecture.  [arXiv:2410.05355;
unverified]

Mamba-1 blocks are mixer-only (no separate MLP: d_ff=0).  Runs long_500k:
decode state is O(1) in context length.
"""
from repro_torch.models.config import ModelConfig, mamba_pattern

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65024,
    pattern=mamba_pattern(),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
)

SMOKE = ModelConfig(
    name="falcon-mamba-7b-smoke",
    num_layers=2,
    d_model=128,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=256,
    pattern=mamba_pattern(),
    ssm_state=8,
    dtype="float32",
)
