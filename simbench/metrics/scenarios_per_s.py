"""``scenarios_per_s``: lanes run to quiescence and summarised on the
host, over all the calls of the window, divided by all the window's
host seconds."""


def read(run):
    return run["items"] / run["window_s"] if run["window_s"] > 0 else None
