from repro_torch.kernels.selective_scan.ops import (  # noqa: F401
    BWD_DESIGN, STATE_SIZES, bwd_blocks_per_sm, selective_scan,
    selective_scan_bwd, selective_scan_cuda, selective_scan_ref)
