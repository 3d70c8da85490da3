"""Conformance of the port's in-run metrics plane, on the CPU: the dense
and streamed planes of ``tests/test_metrics.py``'s conformance cases
against the f64 oracle's ``OracleMetrics`` (its margin-aware rule) and
against the JAX engine's plane on the same scenario, and the planes of
networked and migrating lanes against JAX's (staging drains that retire
at the top of a step, migration steps held for the boundary)."""
import numpy as np
import pytest
import torch

from test_conformance import (NET_SEEDS, POLICY_GRID, STREAM_SEEDS,
                              make_dynamic_scenario,
                              make_networked_scenario, make_scenario,
                              make_streamed_scenario)
from test_metrics import _assert_metrics_conform
from test_metrics import with_metrics as j_with_metrics
from test_torch_state import assert_same_state

from repro.core import engine as JE
from repro.oracle import simulate_dense
from repro.oracle.reference import simulate_stream
from repro_torch.core import engine as E
from repro_torch.core import state as S
from repro_torch.core.convert import from_arrays

CPU = "cpu"


def _port(jdc):
    return from_arrays(jdc, device=CPU)


# ---------------------------------------------------------------------------
# Conformance: the oracle's plane and the JAX engine's
# ---------------------------------------------------------------------------
def _near_bound(out):
    """Cloudlets of a final state that retired within 1e-3 s of their
    SLA bound: f32 responses that agree within 1e-3 may fall on either
    side of it (``test_metrics.py``'s margin-aware rule)."""
    cl = out.cloudlets
    mips = out.vms.req_mips[torch.clamp(cl.vm, min=0).long()].double()
    bound = out.metrics.sla_factor.double() * cl.length.double() / mips
    resp = cl.finish_time.double() - cl.submit_time.double()
    return int(((cl.state == S.CL_DONE)
                & ((resp - bound).abs() <= 1e-3)).sum())


def assert_plane_matches_jax(got, want, ctx, near=0):
    """The port's plane against the JAX engine's on the same scenario:
    counters and histograms exact, except that ``near`` retirements on
    their SLA bound may count either way; float rows within 1e-3 (their
    sums over hosts and cloudlets add in different orders)."""
    for name in ("hist_response", "hist_exec", "hist_wait",
                 "peak_backlog", "enabled"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=f"{ctx} {name}")
    assert abs(int(got.sla_breaches) - int(want.sla_breaches)) <= near, ctx
    for name in ("bucket_dt", "bucket_util", "bucket_watts", "bucket_fleet",
                 "bucket_backlog", "bucket_flows", "host_busy_s",
                 "first_breach_t"):
        np.testing.assert_allclose(
            getattr(got, name).double().numpy(),
            np.asarray(getattr(want, name), np.float64), rtol=1e-3,
            atol=1e-3, err_msg=f"{ctx} {name}")


@pytest.mark.parametrize("vp,tp", POLICY_GRID)
def test_dense_conformance_metrics(vp, tp):
    for seed in range(6):
        jdc = j_with_metrics(make_scenario(seed, vp, tp))
        out = E.run(_port(jdc), max_steps=1024)
        res = simulate_dense(jdc)
        _assert_metrics_conform(out.metrics, res.metrics,
                                f"dense seed {seed} ({vp},{tp})")
        assert int(out.metrics.hist_response.sum()) == res.n_done
        assert_plane_matches_jax(out.metrics,
                                 JE.run(jdc, max_steps=1024).metrics,
                                 f"dense seed {seed}", near=_near_bound(out))


@pytest.mark.parametrize("vp,tp", POLICY_GRID)
def test_streamed_conformance_metrics(vp, tp):
    for seed in STREAM_SEEDS[:4]:
        jdc, jstream = make_streamed_scenario(seed, vp, tp)
        jdc = j_with_metrics(jdc, horizon=64.0)
        out, _, _ = E.run_stream(_port(jdc), from_arrays(
            jstream, device=CPU, cls=S.ArrivalStream), reservoir=32)
        res = simulate_stream(jdc, jstream, reservoir=32)
        _assert_metrics_conform(out.metrics, res.metrics,
                                f"streamed seed {seed} ({vp},{tp})")
        assert int(out.metrics.hist_response.sum()) == res.n_retired
        assert_plane_matches_jax(
            out.metrics, JE.run_stream(jdc, jstream, reservoir=32)[0].metrics,
            f"streamed seed {seed}")


@pytest.mark.parametrize("seed", NET_SEEDS[:4])
def test_networked_and_migrating_planes_match_jax(seed):
    """Staging drains that retire at the top of a step and migration
    steps held for the boundary book each retirement once, as JAX's
    step does; leap on == off."""
    for vp, tp in POLICY_GRID[::3]:
        for make in (make_networked_scenario, make_dynamic_scenario):
            jdc = j_with_metrics(make(seed, vp, tp), horizon=128.0)
            out, stats = E.run_stats(_port(jdc), max_steps=4096)
            want = JE.run(jdc, max_steps=4096)
            ctx = (make.__name__, seed, vp, tp)
            assert_plane_matches_jax(out.metrics, want.metrics, ctx,
                                     near=_near_bound(out))
            assert int(out.metrics.hist_response.sum()) == int(
                (out.cloudlets.state == S.CL_DONE).sum()), ctx
            off = E.run(_port(jdc), max_steps=4096, leap=False)
            assert_same_state(off, out, str(ctx))
