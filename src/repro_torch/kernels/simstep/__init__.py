from repro_torch.kernels.simstep.ops import (  # noqa: F401
    CHUNK, WINDOW, RowIndex, padded_row_index, row_index, simstep,
    simstep_ragged, simstep_ragged_ref, simstep_ref)
