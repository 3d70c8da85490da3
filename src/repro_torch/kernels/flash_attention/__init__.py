from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    HEAD_DIMS, attention, attention_ref, design, flash_attention)
