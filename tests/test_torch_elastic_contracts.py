"""The port's elastic lanes on the contracts of ``tests/test_autoscaling.py``
(its non-sharded cases) and on the port's own bitwise contracts, on the
CPU.

  * the fleet stays in its bounds, no step moves it by more than
    ``scale_step``, actions are ``cooldown`` apart, scale-ups are
    monotone in sustained load, and the spot spend is the exact
    piecewise integral over the trace;
  * a disabled scaler run through the elastic passes is bitwise the
    non-elastic program;
  * leap on == leap off, lane i of a batch == its single run, padded
    lanes are inert, the fused grid == the nested one, each policy
    search cell == its single run, quiescence is a fixed point and the
    block size changes nothing — dense and streamed lanes alike;
  * ``chip_smoke.py``'s numpy copy of the elastic streamed recipe builds
    the very state and stream the JAX generator builds.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from test_autoscaling import EVEN_SEEDS, _initial_fleet, _sustained_load
from test_conformance import (ELASTIC_STREAM_SEEDS, POLICY_GRID,
                              make_elastic_scenario,
                              make_elastic_streamed_scenario)
from test_torch_state import assert_same_state

from repro_torch.core import engine as E
from repro_torch.core import state as S
from repro_torch.core import sweep, telemetry
from repro_torch.core.convert import from_arrays
from repro_torch.core.scheduling import lane_axis
from repro_torch.core.state import map_tensors

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ela(seed, vp=0, tp=0):
    return from_arrays(make_elastic_scenario(seed, vp, tp), device=CPU)


def _stream(seed, vp=0, tp=0):
    dc, stream = make_elastic_streamed_scenario(seed, vp, tp)
    return (from_arrays(dc, device=CPU),
            from_arrays(stream, device=CPU, cls=S.ArrivalStream))


def _load(per_slot):
    return from_arrays(_sustained_load(per_slot), device=CPU)


def _lane(batch, *idx):
    return map_tensors(lambda t: t[idx], batch)


# ---------------------------------------------------------------------------
# The control contracts (tests/test_autoscaling.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", EVEN_SEEDS)
def test_fleet_never_exceeds_max(seed):
    dc = _ela(seed)
    _, trace = E.run_trace(dc, num_steps=512)
    t, fleet = telemetry.fleet_timeline(trace)
    assert fleet.size > 0
    assert fleet.max() <= int(dc.scaler.max_fleet), (seed, fleet.max())


@pytest.mark.parametrize("per_slot", [4, 8])
def test_fleet_stays_within_bounds(per_slot):
    dc = _load(per_slot)
    _, trace = E.run_trace(dc, num_steps=1024)
    t, fleet = telemetry.fleet_timeline(trace)
    fleet0 = _initial_fleet(dc)
    assert fleet.min() >= min(int(dc.scaler.min_fleet), fleet0)
    assert fleet.max() <= int(dc.scaler.max_fleet)
    deltas = np.diff(np.concatenate([[fleet0], fleet]))
    assert np.abs(deltas).max() <= int(dc.scaler.scale_step), deltas


def test_no_action_inside_cooldown():
    dc = _load(8)
    out, trace = E.run_trace(dc, num_steps=1024)
    t, fleet = telemetry.fleet_timeline(trace)
    prev = np.concatenate([[_initial_fleet(dc)], fleet[:-1]])
    action_t = t[fleet != prev].astype(np.float64)
    total = int(out.scaler.up_count) + int(out.scaler.down_count)
    assert total >= int(np.abs(fleet - prev).sum()) > 0
    assert action_t.size >= 2, action_t
    assert np.diff(action_t).min() >= float(dc.scaler.cooldown) - 1e-3


@pytest.mark.parametrize("seed", [0, 4, 1])
def test_disabled_scaler_is_bitwise_non_elastic(seed):
    """enabled = spot_enabled = 0 run through the elastic passes (the
    scaler check every step, the accrual every commit) == the run
    without them, bit for bit."""
    dc = _ela(seed)
    dead = dataclasses.replace(dc, scaler=dataclasses.replace(
        dc.scaler, enabled=torch.zeros((), dtype=torch.int32),
        spot_enabled=torch.zeros((), dtype=torch.int32)))
    assert not E.wants_elastic(dead)
    off = E.run(dead, max_steps=512)
    passes = E._passes_of(dead)._replace(elastic=True)
    on, _ = E._drive(lane_axis(dead), max_steps=512, horizon=float("inf"),
                     provision_policy=0, leap=True, block=E.BLOCK,
                     passes=passes)
    assert_same_state(_lane(on, 0), off, f"seed {seed}")
    assert int(off.scaler.up_count) == 0
    assert float(off.scaler.spot_cost) == 0.0


def test_scale_up_monotone_in_sustained_load():
    ups, downs, executed = [], [], []
    for per_slot in (1, 3, 6, 8):
        dc = _load(per_slot)
        out = E.run(dc, max_steps=4096)
        u, d = int(out.scaler.up_count), int(out.scaler.down_count)
        ups.append(u)
        downs.append(d)
        executed.append(float((out.cloudlets.length.double()
                               - out.cloudlets.remaining.double()).sum()))
        alive = int(((out.vms.state == S.VM_PENDING)
                     | (out.vms.state == S.VM_ACTIVE)).sum())
        assert alive == _initial_fleet(dc) + u - d, (per_slot, alive, u, d)
    assert ups == sorted(ups) and ups[-1] > ups[0], ups
    assert executed == sorted(executed), executed
    assert max(downs) > 0, downs


@pytest.mark.parametrize("seed", EVEN_SEEDS[:4])
def test_spot_cost_is_exact_piecewise_integral(seed):
    dc = _ela(seed)
    assert int(dc.scaler.spot_enabled) == 1
    out, trace = E.run_trace(dc, num_steps=512)
    t, fleet = telemetry.fleet_timeline(trace)
    starts = np.concatenate([[0.0], t[:-1].astype(np.float64)])
    spot_t = dc.scaler.spot_t.double().numpy()
    spot_p = dc.scaler.spot_price.double().numpy()
    seg = np.clip(np.searchsorted(spot_t, starts, side="right") - 1, 0,
                  spot_t.size - 1)
    expected = float(np.sum(spot_p[seg] * fleet.astype(np.float64)
                            * (t.astype(np.float64) - starts)))
    got = float(out.scaler.spot_cost)
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-3)
    assert got > 0.0
    _, spend = telemetry.spot_cost_timeline(trace)
    assert float(spend[-1]) == got


# ---------------------------------------------------------------------------
# The port's bitwise contracts on elastic lanes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_quiescence_is_a_bitwise_fixed_point(seed):
    for vp, tp in POLICY_GRID:
        out = E.run(_ela(seed, vp, tp), max_steps=4096)
        again, rec = E.step(out)
        assert not bool(rec.active)
        assert_same_state(again, out, f"{seed} {vp} {tp}")


@pytest.mark.parametrize("seed", [3, 6])
def test_result_is_invariant_to_block(seed):
    for vp, tp in POLICY_GRID[::3]:
        dc = _ela(seed, vp, tp)
        ref, ref_stats = E.run_stats(dc, max_steps=4096)
        for block in (1, 5):
            got, stats = E.run_stats(dc, max_steps=4096, block=block)
            assert_same_state(got, ref, f"block {block}")
            assert stats.n_events == ref_stats.n_events


def _mixed_batch():
    """Three elastic lanes and one with its scaler and spot track off
    (it leaps)."""
    dcs = [_ela(s, *POLICY_GRID[s % 4]) for s in (0, 1, 2, 4)]
    off = dcs[3]
    dcs[3] = dataclasses.replace(off, scaler=dataclasses.replace(
        off.scaler, enabled=torch.zeros((), dtype=torch.int32),
        spot_enabled=torch.zeros((), dtype=torch.int32)))
    return dcs, sweep.stack_scenarios(dcs)


@pytest.mark.parametrize("leap", [True, False])
def test_batch_lanes_equal_single_runs_bitwise(leap):
    dcs, batch = _mixed_batch()
    out, stats = E.batched_run_stats(batch, max_steps=4096, leap=leap)
    events = 0
    for i in range(len(dcs)):
        single, st = E.run_stats(_lane(batch, i), max_steps=4096, leap=leap)
        assert_same_state(_lane(out, i), single, f"lane {i}")
        events += st.n_events
    assert stats.n_events == events
    assert stats.n_scale > 0


def test_leap_on_equals_leap_off():
    """Enabled lanes never leap, the disabled one does: both spellings
    give the same bits."""
    _, batch = _mixed_batch()
    on, s_on = E.batched_run_stats(batch, max_steps=4096, leap=True)
    off, s_off = E.batched_run_stats(batch, max_steps=4096, leap=False)
    assert_same_state(on, off)
    assert s_on.n_events == s_off.n_events
    assert s_on.n_leap > 0 and s_off.n_leap == 0


def test_padded_lanes_are_inert():
    dcs, batch = _mixed_batch()
    ref = sweep.run_batch(batch, max_steps=4096)
    out = sweep.run_batch(sweep.pad_batch(batch, 7), max_steps=4096)
    assert_same_state(map_tensors(lambda t: t[:4], out), ref)
    pad = map_tensors(lambda t: t[4:], out)
    assert_same_state(pad, map_tensors(
        lambda t: t[4:], sweep.pad_batch(batch, 7)))


def test_fused_grid_equals_nested_and_single_bitwise():
    dcs = [_ela(s) for s in (0, 3)]
    batch = sweep.stack_scenarios(dcs)
    vm_p, task_p = sweep.policy_grid(device=CPU)
    fused = sweep.run_grid(batch, vm_p, task_p, max_steps=4096)
    nested = sweep.run_grid_nested(batch, vm_p, task_p, max_steps=4096)
    assert_same_state(fused, nested)
    for p in range(4):
        for b in range(len(dcs)):
            cell = dataclasses.replace(_lane(batch, b),
                                       vm_policy=vm_p[p].clone(),
                                       task_policy=task_p[p].clone())
            assert_same_state(_lane(fused, p, b), E.run(cell,
                                                        max_steps=4096))


def test_policy_search_cells_match_single_runs():
    dcs = [_ela(s) for s in (0, 2)]
    batch = sweep.stack_scenarios(dcs)
    grid = sweep.policy_points(util_highs=(0.55, 0.72), util_lows=(0.18,),
                               cooldowns=(2.0,), scale_steps=(1, 2),
                               device=CPU)
    final = sweep.run_policy_search(batch, grid, max_steps=512)
    assert final.time.shape == (4, 2)
    for p in range(4):
        for b in range(len(dcs)):
            dc = _lane(batch, b)
            cell = dataclasses.replace(dc, scaler=dataclasses.replace(
                dc.scaler, util_high=grid.util_high[p].clone(),
                util_low=grid.util_low[p].clone(),
                cooldown=grid.cooldown[p].clone(),
                scale_step=grid.scale_step[p].clone(),
                price_sensitivity=grid.price_sensitivity[p].clone()))
            assert_same_state(_lane(final, p, b), E.run(cell,
                                                        max_steps=512),
                              f"cell {p},{b}")


def test_policy_points_drop_inverted_watermarks():
    grid = sweep.policy_points((0.3, 0.6), (0.2, 0.4), (1.0, 2.0),
                               price_sensitivities=(0.0, 0.5), device=CPU)
    assert grid.util_high.shape[0] == (1 + 2) * 2 * 2
    assert bool((grid.util_low < grid.util_high).all())
    with pytest.raises(ValueError):
        sweep.policy_points((0.2,), (0.3,), (1.0,))


# ---------------------------------------------------------------------------
# Elastic streamed lanes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", ELASTIC_STREAM_SEEDS)
def test_streamed_leap_and_chunking_are_invisible(seed):
    dc, stream = _stream(seed, *POLICY_GRID[seed % 4])
    ref = E.run_stream(dc, stream, reservoir=32)
    off = E.run_stream(dc, stream, reservoir=32, leap=False)
    assert_same_state(off[0], ref[0])
    assert_same_state(off[1], ref[1])
    vm = stream.vm.reshape(-1)
    real = vm >= 0
    small = S.make_stream(vm[real], stream.length.reshape(-1)[real],
                          stream.submit.reshape(-1)[real], chunk=4,
                          file_size=stream.file_size.reshape(-1)[real],
                          output_size=stream.output_size.reshape(-1)[real],
                          device=CPU)
    got = E.run_stream(dc, small, reservoir=32)
    assert_same_state(got[0], ref[0])
    assert_same_state(got[1].stats, ref[1].stats)


def test_streamed_batch_lanes_equal_single_runs():
    pairs = [_stream(s, *POLICY_GRID[s % 4]) for s in ELASTIC_STREAM_SEEDS]
    batch = sweep.stack_scenarios([p[0] for p in pairs])
    streams = [p[1] for p in pairs]
    out, st, recs = sweep.run_stream_batch(batch, streams, reservoir=32)
    padded = sweep.pad_batch(batch, len(pairs) + 2)
    queues = sweep.stack_streams(streams)
    inert = sweep.inert_stream_lane(queues)
    queues = S.with_leaves(queues, [
        torch.cat([x, p[None].expand((2,) + p.shape)])
        for x, p in zip(S.tensor_leaves(queues), S.tensor_leaves(inert))])
    pout, pst, _ = sweep.run_stream_batch(padded, queues, reservoir=32)
    for b, (_, stream) in enumerate(pairs):
        one, ost, orec = E.run_stream(_lane(batch, b), stream, reservoir=32)
        assert_same_state(_lane(out, b), one, f"lane {b}")
        assert_same_state(_lane(st, b), ost, f"lane {b}")
        assert_same_state(_lane(pout, b), one, f"padded lane {b}")
    assert int((out.scaler.up_count + out.scaler.down_count).sum()) > 0


@pytest.mark.parametrize("seed", range(4))
def test_chip_smoke_recipe_builds_the_jax_state(seed):
    cs = _chip_smoke()
    dc, stream = cs.elastic_streamed_scenario(seed, CPU)
    jdc, jstream = make_elastic_streamed_scenario(seed, 0, 0)
    assert_same_state(dc, jdc)
    assert_same_state(stream, jstream)
