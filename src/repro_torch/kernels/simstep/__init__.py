from repro_torch.kernels.simstep.ops import (  # noqa: F401
    dense_index, simstep, simstep_cuda, simstep_ref)
