"""Checkpoints of the port's training state (``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    latest_step,
    restore,
    save,
)
