"""Shared fixtures. NOTE: no XLA_FLAGS here — tests must see 1 real device;
only launch/dryrun.py fakes 512 devices (and only in its own process)."""
import os

import numpy as np
import pytest

# Keep CPU tests deterministic and fast.
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def pytest_configure(config):
    # Registered here (no pytest.ini/pyproject tool section in this repo)
    # so `-m "not slow"` / `-m "not subprocess"` give a fast, deterministic
    # tier-1 pass on small hosts; CI runs the full set unfiltered.
    config.addinivalue_line(
        "markers",
        "slow: takes minutes on a loaded 2-core host (XLA recompiles, "
        "forced multi-device backends); deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "subprocess: re-launches the python interpreter with forced "
        "XLA_FLAGS device counts; deselect with -m 'not subprocess'")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the PyTorch port's hand-written "
        "kernels); skips without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
