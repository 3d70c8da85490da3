"""The port's own bitwise contracts on dynamic and networked lanes, on the
CPU (the leap: ``test_torch_dynamic_leap``; its steps against the JAX
engine's: ``test_torch_dynamic_steps``).

  * quiescence is a bit-exact fixed point (``step`` and ``run`` again);
  * the result and the event count do not depend on ``block``;
  * lane i of a mixed static / dynamic / networked batch equals the
    single run, and the fused grid equals the nested one, bit for bit;
  * ``RunStats.n_plans``: a plan per placement change, no more;
  * ``chip_smoke.py``'s numpy copies of the conformance recipes build
    the very states the JAX generators build.
"""
import dataclasses
import importlib.util
import pathlib

import pytest
import torch

from test_conformance import (POLICY_GRID, make_dynamic_scenario,
                              make_networked_scenario, make_scenario)
from test_torch_network import _cut
from test_torch_state import assert_same_state

from repro_torch.core import state as S
from repro_torch.core import sweep
from repro_torch.core.convert import from_arrays
from repro_torch.core.engine import run, run_stats, step

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dyn(seed, vp, tp):
    return from_arrays(make_dynamic_scenario(seed, vp, tp), device=CPU)


def _net(seed, vp, tp):
    return from_arrays(make_networked_scenario(seed, vp, tp), device=CPU)


MAKE = {"dyn": _dyn, "net": _net}


@pytest.mark.parametrize("kind,seed", [("dyn", 0), ("dyn", 1), ("dyn", 5),
                                       ("net", 1), ("net", 2)])
def test_quiescence_is_a_bitwise_fixed_point(kind, seed):
    for vp, tp in POLICY_GRID:
        out = run(MAKE[kind](seed, vp, tp), max_steps=4096)
        again, rec = step(out)
        assert not bool(rec.active)
        assert_same_state(again, out, f"{kind} {seed}")
        assert_same_state(run(out, max_steps=4096), out)


@pytest.mark.parametrize("kind,seed", [("dyn", 2), ("dyn", 4), ("net", 3),
                                       ("net", 5)])
def test_result_is_invariant_to_block(kind, seed):
    for vp, tp in POLICY_GRID:
        dc = MAKE[kind](seed, vp, tp)
        ref, s_ref = run_stats(dc, max_steps=4096, block=1)
        for block in (3, 64):
            out, stats = run_stats(dc, max_steps=4096, block=block)
            assert_same_state(out, ref, f"{kind} {seed} block {block}")
            assert stats.n_events == s_ref.n_events


def _lane(batch, *idx):
    return S.map_tensors(lambda t: t[idx], batch)


@pytest.mark.parametrize("leap", [True, False])
def test_mixed_batch_lanes_equal_single_runs_bitwise(leap):
    """Static, dynamic and networked lanes in one batch: every lane
    equals its single run, and a lane's passes never leak into another
    (the static lanes run under the dynamic and networked passes)."""
    dcs = ([_dyn(s, *POLICY_GRID[s % 4]) for s in (0, 1, 2, 7)]
           + [_net(s, *POLICY_GRID[s % 4]) for s in (1, 2)]
           + [from_arrays(make_scenario(s, *POLICY_GRID[s % 4]),
                          device=CPU) for s in (0, 3)])
    out = sweep.run_batch(sweep.stack_scenarios(dcs), max_steps=4096,
                          leap=leap)
    for i, dc in enumerate(dcs):
        single = run(dc, max_steps=4096, leap=leap)
        assert_same_state(_cut(_lane(out, i), single), single, f"lane {i}")


def test_dynamic_grid_fused_equals_nested_and_single_bitwise():
    dcs = [_dyn(s, *POLICY_GRID[s % 4]) for s in (1, 2)]
    batch = sweep.stack_scenarios(dcs)
    vm_p, task_p = sweep.policy_grid(device=CPU)
    fused = sweep.run_grid(batch, vm_p, task_p, max_steps=4096)
    nested = sweep.run_grid_nested(batch, vm_p, task_p, max_steps=4096)
    assert_same_state(fused, nested)
    for p, b in ((0, 0), (2, 1)):
        cell = dataclasses.replace(dcs[b], vm_policy=vm_p[p].clone(),
                                   task_policy=task_p[p].clone())
        single = run(cell, max_steps=4096)
        assert_same_state(_cut(_lane(fused, p, b), single), single)
    summ = sweep.summarize_batch(fused)
    assert tuple(summ.n_migrations.shape) == (4, 2)
    assert torch.equal(summ.mig_downtime, fused.mig_downtime)


def test_plans_are_rebuilt_once_per_placement_change():
    """A plan is built after the first provisioning, then once per block
    boundary that moved a VM: each applied migration, and each event
    time (whose evictions re-provision at once).  The static path
    builds one."""
    cs = _chip_smoke()
    _, st = run_stats(cs.section5(64, 16, S.TIME_SHARED, CPU),
                      max_steps=512)
    assert st.n_plans == 1
    out, stats = run_stats(cs.migration_scenario(CPU, scale=1),
                           max_steps=1 << 20)
    assert stats.n_plans == 1 + 3 + int(out.mig_count)


@pytest.mark.parametrize("seed", range(6))
def test_chip_smoke_recipes_build_the_jax_states(seed):
    cs = _chip_smoke()
    for vp, tp in POLICY_GRID[:2]:
        assert_same_state(cs.dynamic_scenario(seed, vp, tp, CPU),
                          make_dynamic_scenario(seed, vp, tp))
        assert_same_state(cs.networked_scenario(seed, vp, tp, CPU),
                          make_networked_scenario(seed, vp, tp))
