"""Conformance of the port's dynamic path: the 64 dynamic scenarios of
``tests/test_conformance.py`` (16 ``DYN_SEEDS`` x the 2x2 policy grid:
host failures and recoveries, VM destroys, latent VMs created by an
event, migration OFF / THRESHOLD / DRAIN), each run by
``repro_torch.core.engine.run_stats`` on the CPU.

Against the f64 oracle (``repro.oracle.simulate_dense``), at the
tolerances of ``docs/conformance.md``: completion sets, cloudlet and VM
states, placements, event counts and migration counts exact; start and
finish times, per-host joules and migration downtime within 1e-3;
transferred MB within 1e-3.  Against the JAX engine's ``run`` on the same
scenario: discrete outputs exact, floats at the same tolerances (costs
1e-4 relative).
"""
import numpy as np
import pytest

from test_conformance import (DYN_SEEDS, POLICY_GRID,
                              make_dynamic_scenario)

from repro.core import engine as JE
from repro.oracle import simulate_dense
from repro_torch.core import state as S
from repro_torch.core.convert import from_arrays
from repro_torch.core.engine import run_stats

MAX_STEPS = 4096
CASES = [(seed, vp, tp) for seed in DYN_SEEDS for vp, tp in POLICY_GRID]


def _np(x, dtype=None):
    a = x.numpy() if hasattr(x, "numpy") else np.asarray(x)
    return a if dtype is None else a.astype(dtype)


def assert_matches_oracle(out, stats, res, ctx):
    """The port's final state and event count against the oracle's."""
    assert stats.n_events == res.n_events, ctx
    np.testing.assert_array_equal(_np(out.cloudlets.state), res.cl_state,
                                  err_msg=str(ctx))
    np.testing.assert_array_equal(_np(out.vms.state), res.vm_state,
                                  err_msg=str(ctx))
    np.testing.assert_array_equal(_np(out.vms.host), res.vm_host,
                                  err_msg=str(ctx))
    done = res.cl_state == S.CL_DONE
    close = lambda a, b, what: np.testing.assert_allclose(
        a, b, rtol=0, atol=1e-3, err_msg=f"{ctx} {what}")
    close(_np(out.cloudlets.finish_time, np.float64)[done],
          res.finish_time[done], "finish_time")
    close(_np(out.cloudlets.start_time, np.float64)[done],
          res.start_time[done], "start_time")
    close(_np(out.hosts.energy_j, np.float64), res.energy_j, "energy_j")
    assert int(out.mig_count) == res.n_migrations, ctx
    close(float(out.mig_downtime), res.mig_downtime, "mig_downtime")
    close(float(out.net_transferred_mb), res.transferred_mb,
          "transferred_mb")


def assert_matches_jax(out, want, ctx):
    """The port's final state against the JAX engine's on the same
    scenario: discrete leaves exact, floats at the oracle tolerances."""
    for blk, names in (("cloudlets", ("state", "net_phase")),
                       ("vms", ("state", "host")),
                       ("hosts", ("valid",))):
        for name in names:
            np.testing.assert_array_equal(
                _np(getattr(getattr(out, blk), name)),
                _np(getattr(getattr(want, blk), name)),
                err_msg=f"{ctx} {blk}.{name}")
    np.testing.assert_array_equal(_np(out.event_fired),
                                  _np(want.event_fired), err_msg=str(ctx))
    assert int(out.mig_count) == int(want.mig_count), ctx
    close = lambda a, b, what, rtol=0.0: np.testing.assert_allclose(
        _np(a, np.float64), _np(b, np.float64), rtol=rtol, atol=1e-3,
        err_msg=f"{ctx} {what}")
    for name in ("start_time", "finish_time"):
        close(getattr(out.cloudlets, name), getattr(want.cloudlets, name),
              name)
    close(out.cloudlets.remaining, want.cloudlets.remaining, "remaining",
          rtol=1e-6)
    close(out.hosts.energy_j, want.hosts.energy_j, "energy_j")
    close(out.vms.mig_remaining, want.vms.mig_remaining, "mig_remaining")
    close(out.time, want.time, "time")
    close(out.mig_downtime, want.mig_downtime, "mig_downtime")
    close(out.net_transferred_mb, want.net_transferred_mb,
          "transferred_mb")
    for name in ("cpu_cost", "mem_cost", "storage_cost", "bw_cost"):
        np.testing.assert_allclose(
            float(getattr(out.acct, name)), float(getattr(want.acct, name)),
            rtol=1e-4, atol=1e-9, err_msg=f"{ctx} {name}")


def conform(jdc, ctx):
    """Run ``jdc`` through the port and hold it against the oracle and
    the JAX engine."""
    out, stats = run_stats(from_arrays(jdc, device="cpu"),
                           max_steps=MAX_STEPS)
    assert_matches_oracle(out, stats, simulate_dense(jdc), ctx)
    assert_matches_jax(out, JE.run(jdc, max_steps=MAX_STEPS), ctx)
    return out


@pytest.mark.parametrize("seed,vp,tp", CASES)
def test_dynamic_scenario_conforms(seed, vp, tp):
    conform(make_dynamic_scenario(seed, vp, tp), (seed, vp, tp))


@pytest.mark.parametrize("vp,tp", POLICY_GRID)
def test_dynamic_scenarios_exercise_migration(vp, tp):
    """Each policy row of the 64 migrates somewhere (the oracle's count,
    which the port matches exactly above)."""
    total = sum(simulate_dense(make_dynamic_scenario(seed, vp, tp))
                .n_migrations for seed in DYN_SEEDS)
    assert total > 0
