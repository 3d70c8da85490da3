"""musicgen-large [audio] — 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048, decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

Backbone only: 4 EnCodec codebook streams enter as summed embeddings and
exit through 4 parallel heads; the delay-pattern bookkeeping and text
conditioning are frontend stubs (``input_specs`` supplies codebook ids).
"""
from repro_torch.models.config import ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="musicgen-large",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    pattern=uniform_pattern(),
    num_codebooks=4,
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=64,
    pattern=uniform_pattern(),
    num_codebooks=4,
    dtype="float32",
)
