"""``provision_ms``: the host milliseconds a call spends provisioning VMs
(its ``drive.provision`` spans: ``engine._provision_lanes``, lane by
lane), as the mean over the run's recorded calls (``simbench.spans``)."""
from simbench import spans


def read(run):
    calls = spans.recorded(run)
    if not calls:
        return None
    return sum(spans.total_ms(c, ("drive.provision",))
               for c in calls) / len(calls)
