from repro_torch.kernels.simstep.ops import (  # noqa: F401
    CHUNK, WINDOW, RowIndex, row_index, simstep, simstep_ragged,
    simstep_ragged_ref, simstep_ref)
