"""The port's hand-written CUDA kernels and their plain versions."""
from repro_torch.kernels.flash_attention import (  # noqa: F401
    attention, attention_ref, flash_attention)
from repro_torch.kernels.selective_scan import (  # noqa: F401
    selective_scan, selective_scan_cuda, selective_scan_ref)
from repro_torch.kernels.simstep.ops import (  # noqa: F401
    RowIndex, row_index, simstep, simstep_ragged, simstep_ragged_ref,
    simstep_ref)
