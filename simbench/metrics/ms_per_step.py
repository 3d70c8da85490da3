"""``ms_per_step``: host milliseconds of the ``run`` spans (``fuse_grid``
and ``engine.batched_run_stats``, ending in a synchronisation) over the
steps they evaluated (``RunStats.n_steps + n_leap``), over the window's
calls, which run before the profiler starts."""


def read(run):
    calls = [c for c in run["calls"] if not c["profiled"]]
    steps = sum(c["counters"]["n_steps"] + c["counters"]["n_leap"]
                for c in calls)
    return 1e3 * sum(c["spans"]["run"] for c in calls) / steps \
        if steps else None
