"""The port's static engine against the f64 oracle and the JAX engine.

All 26 conformance seeds x the 2x2 policy grid run through
``repro_torch.core.engine.run`` and are held to the ``docs/conformance.md``
contract against ``repro.oracle.simulate_dense`` (which reads the port's
state directly): exact completion sets, life-cycle states, placements and
event counts; completion times and per-host energy within 1e-3; §3.3
costs within 1e-4 relative of their closed form.  A subset is held to the
JAX engine the same way.
"""
import dataclasses

import numpy as np
import pytest

from test_conformance import POLICY_GRID, SEEDS, make_scenario

from repro.core import state as JS
from repro.core.engine import run_trace as j_run_trace
from repro.oracle import simulate_dense
from repro_torch.core import state as S
from repro_torch.core.convert import from_arrays
from repro_torch.core.engine import run_stats

MARKET = (0.01, 0.001, 1e-4, 0.002)


def _scenario(seed, vp, tp):
    jdc = make_scenario(seed, vp, tp)
    # nonzero §3.3 rates, so costs are checked too
    return dataclasses.replace(jdc, rates=JS.make_market(*MARKET))


def _closed_form_costs(dc, res):
    """f64 costs implied by the oracle's completion set and placements."""
    g = lambda t: np.asarray(t, np.float64)
    cpu, mem, sto, bw = MARKET
    vm_of = np.asarray(dc.cloudlets.vm)
    done = res.cl_state == S.CL_DONE
    placed = res.vm_host >= 0
    host_mips = g(dc.hosts.mips_per_pe)[res.vm_host[vm_of[done]]]
    return {
        "cpu_cost": cpu * np.sum(g(dc.cloudlets.length)[done] / host_mips),
        "mem_cost": mem * np.sum(g(dc.vms.ram)[placed]),
        "storage_cost": sto * np.sum(g(dc.vms.size)[placed]),
        "bw_cost": bw * np.sum(g(dc.cloudlets.file_size)[done]
                               + g(dc.cloudlets.output_size)[done]),
    }


def _assert_close_costs(acct, want, ctx):
    for name, value in want.items():
        np.testing.assert_allclose(float(getattr(acct, name)), value,
                                   rtol=1e-4, atol=1e-9,
                                   err_msg=f"{ctx} {name}")


@pytest.mark.parametrize("vm_policy,task_policy", POLICY_GRID)
def test_engine_matches_oracle(vm_policy, task_policy):
    """104 scenarios: every seed under this policy pair."""
    for seed in SEEDS:
        dc = from_arrays(_scenario(seed, vm_policy, task_policy),
                         device="cpu")
        out, stats = run_stats(dc, max_steps=192)
        res = simulate_dense(dc)
        ctx = str((seed, vm_policy, task_policy))

        np.testing.assert_array_equal(out.cloudlets.state.numpy(),
                                      res.cl_state, err_msg=ctx)
        assert stats.n_events == res.n_events, ctx
        done = res.cl_state == S.CL_DONE
        for name in ("finish_time", "start_time"):
            got = getattr(out.cloudlets, name).numpy().astype(np.float64)
            np.testing.assert_allclose(got[done], getattr(res, name)[done],
                                       rtol=0, atol=1e-3,
                                       err_msg=f"{ctx} {name}")
        np.testing.assert_array_equal(out.vms.state.numpy(), res.vm_state,
                                      err_msg=ctx)
        np.testing.assert_array_equal(out.vms.host.numpy(), res.vm_host,
                                      err_msg=ctx)
        np.testing.assert_allclose(out.hosts.energy_j.numpy(), res.energy_j,
                                   rtol=0, atol=1e-3, err_msg=ctx)
        _assert_close_costs(out.acct, _closed_form_costs(dc, res), ctx)


@pytest.mark.parametrize("vm_policy,task_policy", POLICY_GRID)
def test_engine_matches_jax_engine(vm_policy, task_policy):
    """8 seeds: discrete outputs exact, floats at the oracle tolerances."""
    for seed in SEEDS[:8]:
        jdc = _scenario(seed, vm_policy, task_policy)
        want, trace = j_run_trace(jdc, num_steps=192)
        out, stats = run_stats(from_arrays(jdc, device="cpu"),
                               max_steps=192)
        ctx = str((seed, vm_policy, task_policy))
        assert stats.n_events == int(np.asarray(trace.active).sum()), ctx
        for blk, names in (("cloudlets", ("state",)),
                           ("vms", ("state", "host"))):
            for name in names:
                np.testing.assert_array_equal(
                    getattr(getattr(out, blk), name).numpy(),
                    np.asarray(getattr(getattr(want, blk), name)),
                    err_msg=f"{ctx} {blk}.{name}")
        for name in ("finish_time", "start_time", "remaining"):
            np.testing.assert_allclose(
                getattr(out.cloudlets, name).numpy(),
                np.asarray(getattr(want.cloudlets, name)), rtol=0,
                atol=1e-3, err_msg=f"{ctx} {name}")
        np.testing.assert_allclose(out.hosts.energy_j.numpy(),
                                   np.asarray(want.hosts.energy_j), rtol=0,
                                   atol=1e-3, err_msg=ctx)
        np.testing.assert_allclose(float(out.time), float(want.time),
                                   rtol=0, atol=1e-3, err_msg=ctx)
        for name in ("cpu_cost", "mem_cost", "storage_cost", "bw_cost"):
            np.testing.assert_allclose(float(getattr(out.acct, name)),
                                       float(getattr(want.acct, name)),
                                       rtol=1e-4, atol=1e-9,
                                       err_msg=f"{ctx} {name}")
