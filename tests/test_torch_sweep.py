"""The port's lane batching and sweeps, and simstep's per-row policy.

``repro_torch.core.sweep`` stacks scenarios into a leading lane axis and
``engine.batched_run`` runs every lane at once (one simstep launch a
full step, whatever the number of lanes).  Held here, on the CPU:

  * lane i of ``run_batch`` and of ``run_grid`` equals the port's single
    ``run`` of that scenario and policy pair, bit for bit (16 seeds x the
    2x2 grid); ``run_grid`` == ``run_grid_nested`` bit for bit;
  * the exact Fig. 3 finish times of the fused grid; ragged padding and
    inert lanes stay inert;
  * each lane against the JAX engine's single ``run``: discrete fields
    exact, floats at the ``docs/conformance.md`` tolerances (never
    bitwise: the JAX reference drifts 1-2 ULP across its own lanes);
  * ``summarize_batch`` against JAX's on the same final state;
  * ``simstep_ragged_ref`` with a task policy per row against the JAX
    ``simstep_ref`` run once per policy, and one level-2 call a full
    step for a whole batch.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_conformance import POLICY_GRID, make_scenario
from test_torch_state import assert_same_state

from repro.core import sweep as JSW
from repro.core.engine import run as j_run
from repro.kernels.simstep import simstep_ref as j_simstep_ref
from repro_torch.core import scheduling
from repro_torch.core import state as S
from repro_torch.core import sweep
from repro_torch.core.convert import from_arrays, to_numpy
from repro_torch.core.engine import batched_run_stats, run
from repro_torch.kernels.simstep import (row_index, simstep_ragged_ref,
                                         simstep_ref)


def lane(batch, *idx):
    return S.map_tensors(lambda t: t[idx], batch)


def _scenarios(seeds, grid=POLICY_GRID, **kw):
    return [from_arrays(make_scenario(seed, vp, tp, **kw), device="cpu")
            for seed in seeds for vp, tp in grid]


def _cut(state, single):
    """``state``'s lane cut back to the entity counts of ``single``."""
    h = single.hosts.num_pes.shape[0]
    v = single.vms.req_pes.shape[0]
    c = single.cloudlets.vm.shape[0]
    return dataclasses.replace(
        state,
        hosts=S.map_tensors(lambda t: t[:h], state.hosts),
        vms=S.map_tensors(lambda t: t[:v], state.vms),
        cloudlets=S.map_tensors(lambda t: t[:c], state.cloudlets),
        net=dataclasses.replace(state.net, cluster=state.net.cluster[:h]),
        metrics=dataclasses.replace(
            state.metrics, host_busy_s=state.metrics.host_busy_s[:h]))


@pytest.mark.parametrize("leap", [True, False])
def test_batch_lanes_equal_single_runs_bitwise(leap):
    """16 seeds x the 2x2 grid in one batch: every lane == its single
    run, every leaf."""
    dcs = _scenarios(range(16))
    assert len(dcs) == 64
    out = sweep.run_batch(sweep.stack_scenarios(dcs), max_steps=256,
                          leap=leap)
    for i, dc in enumerate(dcs):
        assert_same_state(lane(out, i), run(dc, max_steps=256, leap=leap),
                          f"lane {i}")


def test_grid_lanes_equal_single_runs_and_nested_bitwise():
    base = _scenarios((0, 4, 7), grid=POLICY_GRID[:2])
    batch = sweep.stack_scenarios(base)
    vm_p, task_p = sweep.policy_grid()
    fused = sweep.run_grid(batch, vm_p, task_p, max_steps=256)
    nested = sweep.run_grid_nested(batch, vm_p, task_p, max_steps=256)
    assert_same_state(fused, nested, "fused vs nested")
    assert fused.time.shape == (4, len(base))
    for p in range(4):
        for b, dc in enumerate(base):
            cell = dataclasses.replace(dc, vm_policy=vm_p[p],
                                       task_policy=task_p[p])
            assert_same_state(lane(fused, p, b), run(cell, max_steps=256),
                              f"cell {p},{b}")


def _fig3():
    hosts = S.make_hosts([2], [100.0], 1024.0, 1000.0, 1e6, device="cpu")
    vms = S.make_vms([2, 2], [100.0] * 2, 128.0, 10.0, 100.0, device="cpu")
    cl = S.make_cloudlets([0, 0, 0, 0, 1, 1, 1, 1], 100.0, device="cpu")
    return S.make_datacenter(hosts, vms, cl, reserve_pes=False,
                             device="cpu")


def test_grid_reproduces_fig3_in_one_call():
    """``test_sweep_grid_reproduces_fig3_in_one_call``'s finish times,
    exactly."""
    batch = sweep.stack_scenarios([_fig3(), _fig3()])
    grid = sweep.run_grid(batch, *sweep.policy_grid(), max_steps=64)
    ft = grid.cloudlets.finish_time.numpy()
    assert ft.shape == (4, 2, 8)
    want = np.asarray([[1, 1, 2, 2, 3, 3, 4, 4], [2, 2, 2, 2, 4, 4, 4, 4],
                       [2, 2, 4, 4, 2, 2, 4, 4], [4] * 8], np.float32)
    for b in range(2):
        np.testing.assert_array_equal(ft[:, b], want)
    summ = sweep.summarize_batch(grid)
    assert summ.n_done.shape == (4, 2) and bool((summ.n_done == 8).all())
    assert bool((summ.makespan == 4.0).all())


def test_ragged_padding_is_inert():
    small = from_arrays(make_scenario(0, 0, 0, n_hosts=2, n_vms=2,
                                      per_vm=2), device="cpu")
    big = from_arrays(make_scenario(1, 1, 1, n_hosts=4, n_vms=5, per_vm=3),
                      device="cpu")
    batch = sweep.stack_scenarios([small, big])
    assert tuple(batch.cloudlets.vm.shape) == (2, 15)
    out = sweep.run_batch(batch, max_steps=256)
    s_small = run(small, max_steps=256)
    assert_same_state(_cut(lane(out, 0), s_small), s_small, "small")
    assert bool((out.cloudlets.state[0, 4:] == S.CL_EMPTY).all())
    assert bool((out.vms.state[0, 2:] == S.VM_EMPTY).all())
    assert bool((out.hosts.energy_j[0, 2:] == 0.0).all())
    assert_same_state(lane(out, 1), run(big, max_steps=256), "big")


def test_inert_lanes_are_fixed_points():
    dcs = _scenarios((2, 3), grid=POLICY_GRID[1:3])
    padded = sweep.pad_batch(sweep.stack_scenarios(dcs), 7)
    out = sweep.run_batch(padded, max_steps=256)
    for i in range(4, 7):
        assert_same_state(lane(out, i), lane(padded, i), f"inert {i}")
    for i, dc in enumerate(dcs):
        assert_same_state(lane(out, i), run(dc, max_steps=256), f"lane {i}")
    # inert lanes alone quiesce with no event
    inert = S.map_tensors(lambda t: t[4:], padded)
    alone, stats = batched_run_stats(inert, max_steps=256)
    assert_same_state(alone, inert)
    assert stats.n_events == 0


@pytest.mark.parametrize("vp,tp", POLICY_GRID)
def test_lanes_match_jax_single_runs(vp, tp):
    """Each lane against the JAX engine's single run: discrete fields
    exact, times and joules within 1e-3 (s, J)."""
    seeds = (0, 4, 7, 11)
    jdcs = [make_scenario(seed, vp, tp) for seed in seeds]
    out = sweep.run_batch(sweep.stack_scenarios(
        [from_arrays(j, device="cpu") for j in jdcs]), max_steps=256)
    for i, jdc in enumerate(jdcs):
        want, got = j_run(jdc, max_steps=256), lane(out, i)
        for blk, name in (("cloudlets", "state"), ("vms", "state"),
                          ("vms", "host")):
            np.testing.assert_array_equal(
                getattr(getattr(got, blk), name).numpy(),
                np.asarray(getattr(getattr(want, blk), name)),
                err_msg=f"{seeds[i]} {blk}.{name}")
        for name in ("remaining", "start_time", "finish_time"):
            np.testing.assert_allclose(
                getattr(got.cloudlets, name).numpy(),
                np.asarray(getattr(want.cloudlets, name)), rtol=0,
                atol=1e-3, err_msg=f"{seeds[i]} {name}")
        np.testing.assert_allclose(got.hosts.energy_j.numpy(),
                                   np.asarray(want.hosts.energy_j), rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(float(got.time), float(want.time),
                                   rtol=0, atol=1e-3)


def test_summarize_batch_matches_jax():
    batch = sweep.stack_scenarios(_scenarios((0, 5), grid=POLICY_GRID[:1]))
    grid = sweep.run_grid(batch, *sweep.policy_grid(), max_steps=256)
    got = sweep.summarize_batch(grid)
    want = JSW.summarize_batch(to_numpy(grid))
    for name in want._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape == (4, 2), name
        np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)


def test_fuse_grid_layout():
    batch = sweep.stack_scenarios(_scenarios((0, 1, 2), grid=[(0, 0)]))
    vm_p, task_p = sweep.policy_grid()
    fused = sweep.fuse_grid(batch, vm_p, task_p)
    assert fused.time.shape == (12,)
    np.testing.assert_array_equal(fused.vm_policy.numpy(),
                                  np.repeat([0, 0, 1, 1], 3))
    np.testing.assert_array_equal(fused.task_policy.numpy(),
                                  np.repeat([0, 1, 0, 1], 3))
    np.testing.assert_array_equal(fused.cloudlets.length.numpy()[7],
                                  batch.cloudlets.length.numpy()[1])
    with pytest.raises(ValueError, match="pair up"):
        sweep.fuse_grid(batch, vm_p, task_p[:3])


def test_stack_matches_jax_stack():
    jdcs = [make_scenario(0, 0, 0, n_hosts=2, n_vms=2, per_vm=2),
            make_scenario(1, 1, 1)]
    got = sweep.stack_scenarios([from_arrays(j, device="cpu")
                                 for j in jdcs])
    assert_same_state(got, JSW.stack_scenarios(jdcs))
    assert_same_state(sweep.inert_lane(got), JSW.inert_lane(
        JSW.stack_scenarios(jdcs)))


def test_batched_level2_is_one_call_a_full_step(monkeypatch):
    """Level 2 runs once a full step for every lane of a batch (one
    simstep launch on the card), with each row's own task policy."""
    calls = []
    real = scheduling.simstep_ragged

    def counted(*args):
        calls.append(args[-1].clone())
        return real(*args)

    monkeypatch.setattr(scheduling, "simstep_ragged", counted)
    batch = sweep.stack_scenarios(_scenarios((0, 1)))
    _, stats = batched_run_stats(batch, max_steps=256)
    assert len(calls) == stats.n_steps > 0
    v = batch.vms.req_pes.shape[1]
    np.testing.assert_array_equal(
        calls[0].numpy(), np.repeat(batch.task_policy.numpy(), v))


# ---------------------------------------------------------------------------
# simstep with a task policy per row
# ---------------------------------------------------------------------------
def _tile(seed, v, k):
    rng = np.random.default_rng(seed)
    rem = rng.uniform(0.0, 5000.0, (v, k)).astype(np.float32)
    rem[rng.uniform(size=(v, k)) < 0.15] = 0.0
    run_ = rng.uniform(size=(v, k)) < 0.7
    cap = rng.uniform(100.0, 2000.0, v).astype(np.float32)
    pes = rng.integers(1, 4, v).astype(np.float32)
    pes[-1] = k + 2
    policy = rng.integers(0, 2, v).astype(np.int32)
    return rem, run_, cap, pes, policy


@pytest.mark.parametrize("v,k", [(8, 16), (13, 8), (3, 40), (50, 10)])
def test_simstep_per_row_policy_matches_jax_per_policy(v, k):
    for seed in range(3):
        rem, run_, cap, pes, policy = _tile(seed, v, k)
        t = lambda a: torch.from_numpy(a.copy())
        index = row_index(torch.arange(v, dtype=torch.int32)
                          .repeat_interleave(k), v)
        rates, dt = simstep_ragged_ref(t(rem).reshape(-1),
                                       t(run_).reshape(-1), index, t(cap),
                                       t(pes), t(policy))
        d_rates, d_dt = simstep_ref(t(rem), t(run_), t(cap), t(pes),
                                    t(policy))
        assert torch.equal(rates.view(v, k), d_rates)
        assert torch.equal(dt, d_dt)
        for p in (0, 1):
            w_rates, w_dt = j_simstep_ref(jnp.asarray(rem),
                                          jnp.asarray(run_),
                                          jnp.asarray(cap), jnp.asarray(pes),
                                          jnp.int32(p))
            rows = policy == p
            np.testing.assert_allclose(rates.view(v, k).numpy()[rows],
                                       np.asarray(w_rates)[rows], rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(dt.numpy()[rows],
                                       np.asarray(w_dt)[rows], rtol=1e-6,
                                       atol=1e-6)
