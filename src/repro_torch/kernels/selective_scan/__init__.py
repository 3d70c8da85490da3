from repro_torch.kernels.selective_scan.ops import (  # noqa: F401
    STATE_SIZES, selective_scan, selective_scan_bwd, selective_scan_cuda,
    selective_scan_ref)
