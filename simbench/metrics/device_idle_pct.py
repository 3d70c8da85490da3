"""``device_idle_pct``: the share of a call's wall in which no kernel,
copy or set runs on the card, in percent.  The device's busy time a
call (the union of its operations' intervals) comes from the profiled
calls' trace; the wall a call from the window's calls, which run before
the profiler starts: it slows the host side of a call (the run line's
``profiler_slowdown``) and would inflate the idle share of the calls it
traces."""


def read(run):
    tr = run["trace"]
    traced = [c for c in run["calls"] if c["profiled"]]
    rest = [c for c in run["calls"] if not c["profiled"]]
    if tr is None or not traced or not rest or tr["busy_s"] <= 0:
        return None
    busy = tr["busy_s"] / len(traced)
    wall = sum(sum(c["spans"].values()) for c in rest) / len(rest)
    return 100.0 * (1.0 - busy / wall)
