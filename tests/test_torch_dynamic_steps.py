"""The port's dynamic and networked steps against the JAX engine's, on
the CPU: ``step``'s ``StepRecord`` event by event (events, migrations,
copies in flight, hosts down, flows, transferred MB; counts exact, floats
at the conformance tolerances), and ``max_steps``/``horizon`` against
JAX's ``run`` (a migration's zero-dt events count as events there too).
"""
import functools

import jax
import numpy as np
import pytest

from test_conformance import (POLICY_GRID, make_dynamic_scenario,
                              make_networked_scenario)

from repro.core import engine as JE
from repro_torch.core.convert import from_arrays
from repro_torch.core.engine import run, run_stats, step

CPU = "cpu"


@functools.lru_cache(maxsize=None)
def _j_step(networked):
    return jax.jit(functools.partial(JE.step, dynamic=True,
                                     networked=networked))


@pytest.mark.parametrize("kind,seed", [("dyn", 1), ("dyn", 2), ("dyn", 8),
                                       ("net", 1), ("net", 2)])
def test_step_records_match_jax(kind, seed):
    """One event at a time, the port's StepRecord against JAX's: counts
    exact, floats at the conformance tolerances."""
    make = {"dyn": make_dynamic_scenario, "net": make_networked_scenario}
    vp, tp = POLICY_GRID[seed % 4]
    jdc = make[kind](seed, vp, tp)
    tdc = from_arrays(jdc, device=CPU)
    jstep = _j_step(kind == "net")
    for k in range(60):
        jdc, jrec = jstep(jdc)
        tdc, trec = step(tdc)
        for name in ("active", "n_running", "n_done", "n_migrating",
                     "migrations", "hosts_down", "n_flows", "n_events",
                     "fleet"):
            assert int(getattr(trec, name)) == int(getattr(jrec, name)), \
                (kind, seed, k, name)
        for name in ("time", "transferred_mb", "watts", "utilization"):
            np.testing.assert_allclose(
                float(getattr(trec, name)), float(getattr(jrec, name)),
                rtol=1e-5, atol=1e-3, err_msg=f"{kind} {seed} {k} {name}")


@pytest.mark.parametrize("k", [3, 17, 40])
def test_max_steps_matches_jax(k):
    """``max_steps`` counts events, migrations' zero-dt events included."""
    for kind, seed in (("dyn", 1), ("dyn", 5), ("net", 3)):
        vp, tp = POLICY_GRID[seed % 4]
        jdc = (make_dynamic_scenario if kind == "dyn"
               else make_networked_scenario)(seed, vp, tp)
        want = JE.run(jdc, max_steps=k)
        got, stats = run_stats(from_arrays(jdc, device=CPU), max_steps=k)
        assert stats.n_events <= k
        for blk, name in (("cloudlets", "state"), ("vms", "host"),
                          ("vms", "state")):
            np.testing.assert_array_equal(
                getattr(getattr(got, blk), name).numpy(),
                np.asarray(getattr(getattr(want, blk), name)),
                err_msg=f"{kind} {seed} {k} {blk}.{name}")
        assert int(got.mig_count) == int(want.mig_count)
        np.testing.assert_allclose(float(got.time), float(want.time),
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("horizon", [6.0, 14.5])
def test_horizon_matches_jax(horizon):
    for kind, seed in (("dyn", 2), ("net", 1)):
        vp, tp = POLICY_GRID[seed % 4]
        jdc = (make_dynamic_scenario if kind == "dyn"
               else make_networked_scenario)(seed, vp, tp)
        want = JE.run(jdc, horizon=horizon)
        got = run(from_arrays(jdc, device=CPU), horizon=horizon, block=5)
        np.testing.assert_array_equal(got.cloudlets.state.numpy(),
                                      np.asarray(want.cloudlets.state))
        np.testing.assert_array_equal(got.event_fired.numpy(),
                                      np.asarray(want.event_fired))
        np.testing.assert_allclose(float(got.time), float(want.time),
                                   rtol=0, atol=1e-3)
