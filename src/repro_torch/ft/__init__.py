"""Fault tolerance studies on the port's simulator: straggler mitigation
for synchronous training (``repro.ft``'s ``straggler`` module)."""
from repro_torch.ft.straggler import (  # noqa: F401
    StragglerReport,
    simulate_sync_training,
)
