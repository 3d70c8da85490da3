"""Device resolution for the port: the card unless the caller asks otherwise.

Every builder and entry point takes ``device=None``.  ``None`` means the
CUDA card; when no card is present that is an error, never a quiet fall
back to the CPU.  Tests and CPU studies pass ``device="cpu"``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device``; ``None`` resolves to ``cuda``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
