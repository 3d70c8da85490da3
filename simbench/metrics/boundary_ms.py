"""``boundary_ms``: the host milliseconds a call spends at the run loop's
block boundaries: its ``drive.read`` spans (the stacked read of each
block's rows) and ``drive.boundary`` spans (admission, event rows, the
autoscaler, migrations, provisioning and the plan), summed, as the mean
over the run's recorded calls (``simbench.spans``)."""
from simbench import spans


def read(run):
    calls = spans.recorded(run)
    if not calls:
        return None
    return sum(spans.total_ms(c, ("drive.read", "drive.boundary"))
               for c in calls) / len(calls)
