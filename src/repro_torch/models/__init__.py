"""LM substrate of the port: one configurable decoder (dense GQA, Mamba-1
SSM, top-k MoE, multi-codebook audio, VLM stub); training is a later
slice."""
from repro_torch.models.config import (  # noqa: F401
    LayerSpec,
    ModelConfig,
    jamba_pattern,
    mamba_pattern,
    uniform_pattern,
)
from repro_torch.models.model import (  # noqa: F401
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)
