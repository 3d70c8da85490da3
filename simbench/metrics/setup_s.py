"""``setup_s``: process start to the end of the warm-up call (imports,
the CUDA context, the simstep library built or loaded, one call at the
cell's shapes), by the host clock."""


def read(run):
    return run["setup_s"]
