"""``build_ms``: the mean host milliseconds of a call's ``build`` span
(the program's builders and ``sweep.stack_scenarios``, ending in a
synchronisation), over the window's calls, which run before the
profiler starts."""


def read(run):
    calls = [c for c in run["calls"] if not c["profiled"]]
    spans = [c["spans"]["build"] for c in calls]
    return 1e3 * sum(spans) / len(spans) if spans else None
