"""Conformance of the port's streamed path: the 32 streamed scenarios of
``tests/test_conformance.py`` (8 ``STREAM_SEEDS`` x the 2x2 policy grid;
windows of 4-12 slots under traces of 40-80 arrivals; odd seeds add
host failures, a VM destroy mid-trace, a migration policy and a
staged-transfer topology), each run by ``repro_torch``'s ``run_stream``
on the CPU.

Against the f64 oracle (``repro.oracle.simulate_stream``) at the
tolerances of ``test_engine_matches_oracle_streamed``: retirement and
failure counts, per-VM completions, the reservoir's arrival ids,
placements and migration counts exact; makespan, sums, clock, energy
and the sampled times within 1e-3.  Against the JAX engine's
``run_stream`` on the same scenario: the discrete outputs (counts,
reservoir ids, the window's states, VMs and ranks, peak occupancy, max
backlog, every chunk record's integer fields) exact; floats at the same
tolerances.
"""
import numpy as np
import pytest

from test_conformance import (POLICY_GRID, STREAM_SEEDS,
                              make_streamed_scenario)

from repro.core import engine as JE
from repro.oracle.reference import simulate_stream
from repro_torch.core import state as S
from repro_torch.core.convert import from_arrays
from repro_torch.core.engine import run_stream_stats

RESERVOIR = 32


def _np(x, dtype=None):
    a = x.numpy() if hasattr(x, "numpy") else np.asarray(x)
    return a if dtype is None else a.astype(dtype)


def assert_matches_oracle(out, st, res, ctx):
    stats = st.stats
    assert int(stats.n_retired) == res.n_retired, ctx
    assert int(stats.n_failed) == res.n_failed, ctx
    np.testing.assert_array_equal(_np(stats.per_vm_done), res.per_vm_done,
                                  err_msg=str(ctx))
    assert int(stats.stride) == res.stride, ctx
    np.testing.assert_array_equal(_np(stats.res_sid), res.res_sid,
                                  err_msg=str(ctx))
    close = lambda a, b, what, rtol=0.0: np.testing.assert_allclose(
        a, b, rtol=rtol, atol=1e-3, err_msg=f"{ctx} {what}")
    close(float(stats.makespan), res.makespan, "makespan")
    close(float(stats.sum_exec), res.sum_exec, "sum_exec", 1e-3)
    close(float(stats.sum_response), res.sum_response, "sum_response", 1e-3)
    close(float(out.time), res.time, "time")
    close(_np(out.hosts.energy_j, np.float64), res.energy_j, "energy_j",
          1e-3)
    filled = res.res_sid >= 0
    fin = filled & (res.res_finish < 1e29)
    np.testing.assert_array_equal(
        _np(stats.res_finish)[filled] >= np.float32(1e29),
        res.res_finish[filled] >= 1e29, err_msg=str(ctx))
    close(_np(stats.res_start, np.float64)[fin], res.res_start[fin],
          "res_start")
    close(_np(stats.res_finish, np.float64)[fin], res.res_finish[fin],
          "res_finish")
    np.testing.assert_array_equal(_np(out.vms.state), res.vm_state,
                                  err_msg=str(ctx))
    np.testing.assert_array_equal(_np(out.vms.host), res.vm_host,
                                  err_msg=str(ctx))
    assert int(out.mig_count) == res.n_migrations, ctx
    close(float(out.net_transferred_mb), res.transferred_mb,
          "transferred_mb", 1e-3)


def assert_matches_jax(out, st, recs, want, ctx):
    jout, jst, jrecs = want
    for name in ("n_retired", "n_failed", "per_vm_done", "stride",
                 "res_sid"):
        np.testing.assert_array_equal(_np(getattr(st.stats, name)),
                                      _np(getattr(jst.stats, name)),
                                      err_msg=f"{ctx} {name}")
    for name in ("peak_occupancy", "max_backlog", "next_sid", "vm_rank",
                 "slot_sid", "cursor"):
        np.testing.assert_array_equal(_np(getattr(st, name)),
                                      _np(getattr(jst, name)),
                                      err_msg=f"{ctx} {name}")
    for name in ("state", "vm", "rank_in_vm", "net_phase"):
        np.testing.assert_array_equal(_np(getattr(out.cloudlets, name)),
                                      _np(getattr(jout.cloudlets, name)),
                                      err_msg=f"{ctx} cloudlets.{name}")
    np.testing.assert_array_equal(_np(out.vms.state), _np(jout.vms.state))
    np.testing.assert_array_equal(_np(out.vms.host), _np(jout.vms.host))
    assert int(out.mig_count) == int(jout.mig_count), ctx
    for name in recs._fields[1:]:
        np.testing.assert_array_equal(_np(getattr(recs, name)),
                                      _np(getattr(jrecs, name)),
                                      err_msg=f"{ctx} records.{name}")
    close = lambda a, b, what, rtol=0.0: np.testing.assert_allclose(
        _np(a, np.float64), _np(b, np.float64), rtol=rtol, atol=1e-3,
        err_msg=f"{ctx} {what}")
    close(recs.time, jrecs.time, "records.time")
    close(st.stats.makespan, jst.stats.makespan, "makespan")
    for name in ("sum_exec", "sum_response", "sum_len"):
        close(getattr(st.stats, name), getattr(jst.stats, name), name, 1e-3)
    for name in ("res_start", "res_finish"):
        close(getattr(st.stats, name), getattr(jst.stats, name), name)
    for name in ("start_time", "finish_time"):
        close(getattr(out.cloudlets, name), getattr(jout.cloudlets, name),
              name)
    close(out.cloudlets.remaining, jout.cloudlets.remaining, "remaining",
          1e-6)
    close(out.hosts.energy_j, jout.hosts.energy_j, "energy_j", 1e-3)
    close(out.time, jout.time, "time")
    close(out.net_transferred_mb, jout.net_transferred_mb, "transferred")
    for name in ("cpu_cost", "bw_cost"):
        np.testing.assert_allclose(
            float(getattr(out.acct, name)), float(getattr(jout.acct, name)),
            rtol=1e-4, atol=1e-9, err_msg=f"{ctx} {name}")


@pytest.mark.parametrize("seed", STREAM_SEEDS)
def test_streamed_scenarios_conform(seed):
    """One seed across the 2x2 grid (its four cells share the JAX
    engine's compiled program)."""
    for vp, tp in POLICY_GRID:
        ctx = (seed, vp, tp)
        dc, stream = make_streamed_scenario(seed, vp, tp)
        out, st, recs, _ = run_stream_stats(
            from_arrays(dc, device="cpu"),
            from_arrays(stream, device="cpu", cls=S.ArrivalStream),
            reservoir=RESERVOIR)
        assert_matches_oracle(out, st, simulate_stream(
            dc, stream, reservoir=RESERVOIR), ctx)
        assert_matches_jax(out, st, recs,
                           JE.run_stream(dc, stream, reservoir=RESERVOIR),
                           ctx)


def test_streamed_scenarios_exercise_the_window():
    """The generator reaches what the port must get right: traces much
    longer than their windows (recycled slots), dead-VM arrivals, and
    (odd seeds) event rows and staged transfers."""
    failed = mb = 0
    for seed in STREAM_SEEDS:
        dc, stream = make_streamed_scenario(seed, 0, 1)
        res = simulate_stream(dc, stream, reservoir=RESERVOIR)
        n = int((np.asarray(stream.vm) >= 0).sum())
        assert n > 4 * dc.cloudlets.vm.shape[0]
        assert (dc.events.shape[0] > 0) == (seed % 2 == 1)
        failed += res.n_failed
        mb += res.transferred_mb
    assert failed > 0 and mb > 0
