"""Conformance of the port's elastic path, space-shared task policy: the
``ELASTIC_SEEDS`` scenarios of ``tests/test_conformance.py`` (a watermark
autoscaler over latent EMPTY slots, drain-and-destroy scale-downs,
cooldowns, fleet clamps, spot tracks whose boundaries are events,
price-sensitivity vetoes; odd seeds add a host failure and recovery)
and the ``ELASTIC_STREAM_SEEDS`` streamed ones, each run by
``repro_torch`` on the CPU.  The time-shared half is
``test_torch_elastic_conformance_ts.py``.

Against the f64 oracle at ``test_engine_matches_oracle_elastic``'s
tolerances: event counts, cloudlet and VM states, placements and up/down
counts exact; start and finish times and per-host joules within 1e-3;
spot spend within 1e-4 relative (atol 1e-3).  Against the JAX engine's
``run``/``run_stream`` on the same scenario: discrete outputs exact,
floats at the same tolerances.
"""
import numpy as np
import pytest

from test_conformance import (ELASTIC_SEEDS, ELASTIC_STREAM_SEEDS,
                              make_elastic_scenario,
                              make_elastic_streamed_scenario)

from repro.core import engine as JE
from repro.oracle import simulate_dense
from repro.oracle.reference import simulate_stream
from repro_torch.core import state as S
from repro_torch.core.convert import from_arrays
from repro_torch.core.engine import run_stats, run_stream_stats

MAX_STEPS = 4096
RESERVOIR = 32
TASK_POLICY = S.SPACE_SHARED


def _np(x, dtype=None):
    a = x.numpy() if hasattr(x, "numpy") else np.asarray(x)
    return a if dtype is None else a.astype(dtype)


def _close(a, b, ctx, what, rtol=0.0):
    np.testing.assert_allclose(_np(a, np.float64), _np(b, np.float64),
                               rtol=rtol, atol=1e-3, err_msg=f"{ctx} {what}")


def assert_scaler_matches(out, up, down, spot, ctx):
    assert int(out.scaler.up_count) == int(up), ctx
    assert int(out.scaler.down_count) == int(down), ctx
    np.testing.assert_allclose(float(out.scaler.spot_cost), float(spot),
                               rtol=1e-4, atol=1e-3, err_msg=f"{ctx} spot")


def assert_dense_conforms(out, stats, res, want, ctx):
    """``out`` (with ``stats``) against the oracle's ``res`` and JAX's
    final state ``want``."""
    assert stats.n_events == res.n_events, ctx
    for got, oracle, jax_ in (
            (out.cloudlets.state, res.cl_state, want.cloudlets.state),
            (out.vms.state, res.vm_state, want.vms.state),
            (out.vms.host, res.vm_host, want.vms.host)):
        np.testing.assert_array_equal(_np(got), oracle, err_msg=str(ctx))
        np.testing.assert_array_equal(_np(got), _np(jax_), err_msg=str(ctx))
    np.testing.assert_array_equal(_np(out.event_fired),
                                  _np(want.event_fired), err_msg=str(ctx))
    done = res.cl_state == S.CL_DONE
    for name in ("finish_time", "start_time"):
        got = getattr(out.cloudlets, name)
        _close(_np(got)[done], getattr(res, name)[done], ctx, name)
        _close(got, getattr(want.cloudlets, name), ctx, f"jax {name}")
    _close(out.hosts.energy_j, res.energy_j, ctx, "energy_j")
    _close(out.hosts.energy_j, want.hosts.energy_j, ctx, "jax energy_j")
    _close(out.time, want.time, ctx, "time")
    assert_scaler_matches(out, res.scale_up_count, res.scale_down_count,
                          res.spot_cost, ctx)
    assert_scaler_matches(out, want.scaler.up_count, want.scaler.down_count,
                          want.scaler.spot_cost, ctx)
    for name in ("cpu_cost", "mem_cost", "storage_cost", "bw_cost"):
        np.testing.assert_allclose(
            float(getattr(out.acct, name)), float(getattr(want.acct, name)),
            rtol=1e-4, atol=1e-9, err_msg=f"{ctx} {name}")


def assert_stream_conforms(out, st, res, want, ctx):
    jout, jst, _ = want
    stats = st.stats
    for name in ("n_retired", "n_failed", "per_vm_done", "res_sid"):
        np.testing.assert_array_equal(_np(getattr(stats, name)),
                                      _np(getattr(jst.stats, name)),
                                      err_msg=f"{ctx} {name}")
    assert int(stats.n_retired) == res.n_retired, ctx
    assert int(stats.n_failed) == res.n_failed, ctx
    np.testing.assert_array_equal(_np(stats.per_vm_done), res.per_vm_done,
                                  err_msg=str(ctx))
    for got, oracle, jax_ in ((out.vms.state, res.vm_state, jout.vms.state),
                              (out.vms.host, res.vm_host, jout.vms.host)):
        np.testing.assert_array_equal(_np(got), oracle, err_msg=str(ctx))
        np.testing.assert_array_equal(_np(got), _np(jax_), err_msg=str(ctx))
    for name in ("state", "vm", "rank_in_vm"):
        np.testing.assert_array_equal(_np(getattr(out.cloudlets, name)),
                                      _np(getattr(jout.cloudlets, name)),
                                      err_msg=f"{ctx} cloudlets.{name}")
    _close(stats.makespan, res.makespan, ctx, "makespan")
    _close(out.time, res.time, ctx, "time")
    _close(out.hosts.energy_j, res.energy_j, ctx, "energy_j", 1e-3)
    _close(out.hosts.energy_j, jout.hosts.energy_j, ctx, "jax energy_j",
           1e-3)
    assert_scaler_matches(out, res.scale_up_count, res.scale_down_count,
                          res.spot_cost, ctx)
    assert_scaler_matches(out, jout.scaler.up_count, jout.scaler.down_count,
                          jout.scaler.spot_cost, ctx)


def conform_dense(seed, vp, tp):
    ctx = (seed, vp, tp)
    jdc = make_elastic_scenario(seed, vp, tp)
    out, stats = run_stats(from_arrays(jdc, device="cpu"),
                           max_steps=MAX_STEPS)
    assert_dense_conforms(out, stats, simulate_dense(jdc),
                          JE.run(jdc, max_steps=MAX_STEPS), ctx)
    return out


def conform_stream(seed, vp, tp):
    ctx = (seed, vp, tp)
    jdc, jstream = make_elastic_streamed_scenario(seed, vp, tp)
    out, st, _, _ = run_stream_stats(
        from_arrays(jdc, device="cpu"),
        from_arrays(jstream, device="cpu", cls=S.ArrivalStream),
        reservoir=RESERVOIR)
    assert_stream_conforms(
        out, st, simulate_stream(jdc, jstream, reservoir=RESERVOIR),
        JE.run_stream(jdc, jstream, reservoir=RESERVOIR), ctx)
    return out


@pytest.mark.parametrize("vp", [S.SPACE_SHARED, S.TIME_SHARED])
@pytest.mark.parametrize("seed", ELASTIC_SEEDS)
def test_elastic_scenario_conforms(seed, vp):
    conform_dense(seed, vp, TASK_POLICY)


@pytest.mark.parametrize("vp", [S.SPACE_SHARED, S.TIME_SHARED])
@pytest.mark.parametrize("seed", ELASTIC_STREAM_SEEDS)
def test_elastic_streamed_scenario_conforms(seed, vp):
    conform_stream(seed, vp, TASK_POLICY)


def test_elastic_scenarios_exercise_the_loop():
    """The generator reaches both directions and the spot track under
    this task policy (the oracle's counts, which the port matches)."""
    ups = downs = 0
    spot = 0.0
    for seed in ELASTIC_SEEDS:
        for vp in (S.SPACE_SHARED, S.TIME_SHARED):
            res = simulate_dense(make_elastic_scenario(seed, vp,
                                                       TASK_POLICY))
            ups += res.scale_up_count
            downs += res.scale_down_count
            spot += res.spot_cost
    assert ups > 0 and downs > 0 and spot > 0.0
