"""``step_host_ms``: what issuing one step costs the host: the
``step.full`` and ``step.leap`` spans' milliseconds of the run's
recorded calls (``simbench.spans``) over the steps they evaluated
(``RunStats.n_steps + n_leap``).  Block boundaries are left out;
``ms_per_step`` keeps them in."""
from simbench import spans


def read(run):
    calls = spans.recorded(run)
    n = sum(spans.steps(c) for c in calls)
    if not n:
        return None
    return sum(spans.total_ms(c, ("step.full", "step.leap"))
               for c in calls) / n
