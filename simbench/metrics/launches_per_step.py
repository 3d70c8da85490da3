"""``launches_per_step``: device operations (kernels, copies and sets)
in the profiled calls' trace, over the steps those calls evaluated
(``RunStats.n_steps + n_leap``).  Build and summary launches count too:
they are the calls' own."""


def read(run):
    tr = run["trace"]
    calls = [c for c in run["calls"] if c["profiled"]]
    steps = sum(c["counters"]["n_steps"] + c["counters"]["n_leap"]
                for c in calls)
    if tr is None or not steps:
        return None
    return tr["n_ops"] / steps
