"""Fault tolerance (``repro.ft``): the checkpoint/restart supervisor of
training, and straggler mitigation for synchronous training studied on
the port's simulator."""
from repro_torch.ft.supervisor import (  # noqa: F401
    FailureInjector,
    SimulatedFailure,
    Supervisor,
    SupervisorReport,
)
from repro_torch.ft.straggler import (  # noqa: F401
    StragglerReport,
    simulate_sync_training,
)
