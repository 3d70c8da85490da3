"""The port's elasticity studies (``repro_torch.core.experiments``)
against the JAX package's, on the CPU: ``sla_violations`` on the same
final states, ``pareto_front`` on the same tables, and
``run_elasticity_study`` on the same batch and policy grid, with and
without a metrics plane: the Pareto mask and the SLA counts exact, cost
and energy within 1e-4 relative, the latency columns equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_conformance import make_elastic_scenario, make_scenario
from test_metrics import with_metrics as j_with_metrics

from repro.core import engine as JE
from repro.core import experiments as JX
from repro.core import sweep as JSW
from repro_torch.core import engine as E
from repro_torch.core import experiments as X
from repro_torch.core import sweep
from repro_torch.core.convert import from_arrays

CPU = "cpu"


@pytest.mark.parametrize("seed", range(4))
def test_sla_violations_match_jax(seed):
    for make in (make_scenario, make_elastic_scenario):
        jdc = make(seed, seed % 2, (seed // 2) % 2)
        jout = JE.run(jdc, max_steps=4096)
        out = from_arrays(jout, device=CPU)
        for factor in (1.0, 2.0, 5.0):
            for unfinished in (False, True):
                got = X.sla_violations(out, factor=factor,
                                       include_unfinished=unfinished)
                want = JX.sla_violations(jout, factor=factor,
                                         include_unfinished=unfinished)
                assert got.dtype == torch.int32
                assert int(got) == int(want), (seed, factor, unfinished)
        # leading batch axes pass through
        two = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), jout)
        np.testing.assert_array_equal(
            X.sla_violations(from_arrays(two, device=CPU)).numpy(),
            np.asarray(JX.sla_violations(two)))


@pytest.mark.parametrize("seed", range(6))
def test_pareto_front_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 6, (12, 3)).astype(np.float64)
    pts[3] = pts[7]                       # a duplicate
    np.testing.assert_array_equal(X.pareto_front(pts), JX.pareto_front(pts))
    assert X.pareto_front(pts).any()
    with pytest.raises(ValueError):
        X.pareto_front(pts[0])


def _grid(mod, **kw):
    return mod.policy_points(util_highs=(0.55, 0.72), util_lows=(0.18,),
                             cooldowns=(1.0, 3.0), **kw)


@pytest.mark.parametrize("probed", [False, True])
def test_run_elasticity_study_matches_jax(probed):
    jdcs = [make_elastic_scenario(s, 0, 0) for s in (0, 2, 4)]
    if probed:
        jdcs = [j_with_metrics(d, horizon=64.0) for d in jdcs]
    jbatch = JSW.stack_scenarios(jdcs)
    want = JX.run_elasticity_study(jbatch, _grid(JSW), max_steps=4096)
    batch = sweep.stack_scenarios([from_arrays(d, device=CPU)
                                   for d in jdcs])
    got = X.run_elasticity_study(batch, _grid(sweep, device=CPU),
                                 max_steps=4096)
    np.testing.assert_array_equal(got.pareto, want.pareto)
    np.testing.assert_array_equal(got.sla.numpy(), np.asarray(want.sla))
    assert int(got.static_sla) == int(want.static_sla)
    for a, b in ((got.cost, want.cost), (got.energy_j, want.energy_j),
                 (got.static_cost, want.static_cost),
                 (got.static_energy_j, want.static_energy_j)):
        np.testing.assert_allclose(a.double().numpy(),
                                   np.asarray(b, np.float64), rtol=1e-4)
    np.testing.assert_array_equal(got.latency_p50, want.latency_p50)
    np.testing.assert_array_equal(got.latency_p95, want.latency_p95)
    np.testing.assert_allclose(got.first_breach_t, want.first_breach_t,
                               rtol=0, atol=1e-3)
    assert np.isnan(got.latency_p50).all() != probed
    for name in ("n_done", "n_scale_up", "n_scale_down"):
        np.testing.assert_array_equal(
            getattr(got.summary, name).numpy(),
            np.asarray(getattr(want.summary, name)), err_msg=name)
    # the search's cells are the engine's single runs
    cell = E.run(_cell(batch, got.grid, 1, 2), max_steps=4096)
    assert torch.equal(cell.cloudlets.finish_time,
                       got.final.cloudlets.finish_time[1, 2])


def _cell(batch, grid, p, b):
    from repro_torch.core.state import map_tensors
    dc = map_tensors(lambda t: t[b], batch)
    return dataclasses.replace(dc, scaler=dataclasses.replace(
        dc.scaler, enabled=torch.ones((), dtype=torch.int32),
        util_high=grid.util_high[p].clone(),
        util_low=grid.util_low[p].clone(),
        cooldown=grid.cooldown[p].clone(),
        scale_step=grid.scale_step[p].clone(),
        price_sensitivity=grid.price_sensitivity[p].clone()))
