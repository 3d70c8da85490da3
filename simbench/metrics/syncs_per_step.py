"""``syncs_per_step``: the sites where the run loop waits for the device:
``sync.*`` spans inside ``drive`` (``engine._drive``) of the run's
recorded calls (``simbench.spans``), over the steps they evaluated
(``RunStats.n_steps + n_leap``).  A site counts once a visit, however
many waits it holds (``bincount`` makes 2); pageable host-to-device
copies count, as they wait too."""
from simbench import spans


def read(run):
    calls = spans.recorded(run)
    n = sum(spans.steps(c) for c in calls)
    if not n:
        return None
    return sum(spans.sync_sites(c) for c in calls) / n
