"""The port's lane dispatcher (``sweep.run_sharded`` and the ``devices``
arguments of ``run_grid``, ``run_stream_batch`` and
``run_policy_search``) on the CPU, devices given as lists of CPU devices
and run in-process.

Counterparts of ``tests/test_sweep_sharded.py``'s one-device case and
its three two-device cases (static, networked and dynamic lanes), of
``tests/test_leap_parity.py::test_dispatch_partitioner_single_device_bitwise``,
of the sharded cases of ``tests/test_autoscaling.py`` and
``tests/test_metrics.py``, and of
``tests/test_streaming.py::test_stream_sharded_gspmd_bitwise``.  Every
spelling equals ``run_batch`` (or the unsharded grid) bit for bit, every
leaf.  JAX's ``"gspmd"`` and ``"shard_map"`` over a device list raise
``ValueError`` (they split lanes over the ranks of a mesh:
``test_torch_sweep_ranks.py``); the dispatcher's chunk order is JAX's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_conformance import (POLICY_GRID, make_dynamic_scenario,
                              make_elastic_scenario, make_networked_scenario,
                              make_scenario)
from test_torch_metrics import _metric_batch
from test_torch_stream_contracts import _infra, _random_stream

from repro.core import sweep as JSW
from repro_torch.core import engine as E
from repro_torch.core import experiments as X
from repro_torch.core import state as S
from repro_torch.core import sweep
from repro_torch.core.convert import from_arrays
from repro_torch.core.state import map_tensors, tensor_leaves

CPU = "cpu"
TWO = [CPU, CPU]


def _port(jdc):
    return from_arrays(jdc, device=CPU)


def _lane(batch, *idx):
    return map_tensors(lambda t: t[idx], batch)


def _same(a, b, ctx):
    """Two trees (states, tuples of states or records) equal, every
    leaf, bit for bit."""
    if isinstance(a, tuple) and not dataclasses.is_dataclass(a):
        assert len(a) == len(b), ctx
        for x, y in zip(a, b):
            _same(x, y, ctx)
        return
    la, lb = tensor_leaves(a), tensor_leaves(b)
    assert len(la) == len(lb), ctx
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, ctx
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=ctx)


def _static(n=3):
    dcs = [_port(make_scenario(s, *POLICY_GRID[s % 4])) for s in range(n)]
    return dcs, sweep.stack_scenarios(dcs)


# ---------------------------------------------------------------------------
# tests/test_sweep_sharded.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("partitioner", ["dispatch", "auto"])
def test_run_sharded_on_one_device_is_bitwise(partitioner):
    """The dispatcher over a one-device list changes nothing."""
    _, batch = _static()
    ref = sweep.run_batch(batch, max_steps=256)
    out = sweep.run_sharded(batch, devices=[CPU], max_steps=256,
                            partitioner=partitioner)
    _same(out, ref, partitioner)


def test_sharded_two_devices_matches_single_device_bitwise():
    """``run_grid`` over two devices == the unsharded grid, every leaf;
    an odd lane count; each lane == the plain single run."""
    dcs, batch = _static()
    vm_p, task_p = sweep.policy_grid(device=CPU)
    sharded = sweep.run_grid(batch, vm_p, task_p, max_steps=192,
                             devices=TWO, partitioner="dispatch")
    single = sweep.run_grid(batch, vm_p, task_p, max_steps=192,
                            sharded=False)
    _same(sharded, single, "two-device grid")
    odd = sweep.run_sharded(sweep.fuse_grid(batch, vm_p[:1], task_p[:1]),
                            devices=TWO, max_steps=192,
                            partitioner="dispatch")
    _same(odd, _lane(single, 0), "odd lane count")
    # scenario i's own policies sit at grid row i % 4
    for i, dc in enumerate(dcs):
        _same(_lane(sharded, i % 4, i), E.run(dc, max_steps=192),
              f"lane {i} vs its single run")


def test_sharded_two_devices_networked_lanes_bitwise():
    vm_p, task_p = sweep.policy_grid(device=CPU)
    net = [_port(make_networked_scenario(s, *POLICY_GRID[s % 4]))
           for s in (0, 2)]
    nbatch = sweep.stack_scenarios(net)
    nsingle = sweep.run_grid(nbatch, vm_p, task_p, max_steps=768,
                             sharded=False)
    nshard = sweep.run_grid(nbatch, vm_p, task_p, max_steps=768,
                            devices=TWO, partitioner="dispatch")
    _same(nshard, nsingle, "networked dispatch")
    assert float(nsingle.net_transferred_mb.sum()) > 0.0


def test_sharded_two_devices_dynamic_lanes_bitwise():
    """Dynamic lanes land round-robin on both devices (the cost-sorted
    permutation and its inverse); leap-off single runs are the ground
    truth."""
    vm_p, task_p = sweep.policy_grid(device=CPU)
    dyn = [_port(make_dynamic_scenario(s, *POLICY_GRID[s % 4]))
           for s in (0, 2)]
    dbatch = sweep.stack_scenarios(dyn)
    dsingle = sweep.run_grid(dbatch, vm_p, task_p, max_steps=384,
                             sharded=False)
    dshard = sweep.run_grid(dbatch, vm_p, task_p, max_steps=384,
                            devices=TWO, partitioner="dispatch")
    _same(dshard, dsingle, "dynamic dispatch")
    assert int(dsingle.mig_count.sum()) > 0
    for i, s in enumerate((0, 2)):        # the padded lane, leap off
        ref = E.run(_lane(dbatch, i), max_steps=384, leap=False)
        _same(_lane(dsingle, s % 4, i), ref, f"leap-off lane {i}")


# ---------------------------------------------------------------------------
# tests/test_leap_parity.py, tests/test_autoscaling.py, tests/test_metrics.py
# ---------------------------------------------------------------------------
def test_dispatch_partitioner_single_device_bitwise():
    _, batch = _static(5)
    ref = sweep.run_batch(batch, max_steps=256)
    out = sweep.run_sharded(batch, devices=[CPU], max_steps=256,
                            partitioner="dispatch")
    _same(out, ref, "dispatch vs run_batch")


def _elastic():
    dcs = [_port(make_elastic_scenario(s, 0, 0)) for s in (0, 2, 4)]
    return dcs, sweep.stack_scenarios(dcs)


def test_elastic_lanes_bitwise_through_sharded_sweeps():
    dcs, batch = _elastic()
    out = sweep.run_batch(batch, max_steps=512)
    for i, dc in enumerate(dcs):
        _same(_lane(out, i), E.run(dc, max_steps=512), f"lane {i}")
    sh = sweep.run_sharded(batch, devices=[CPU], max_steps=512,
                           partitioner="dispatch")
    _same(sh, out, "elastic dispatch vs run_batch")


def test_sharded_two_devices_elastic_lanes_bitwise():
    _, batch = _elastic()
    single = sweep.run_batch(batch, max_steps=512)
    sh = sweep.run_sharded(batch, devices=TWO, max_steps=512,
                           partitioner="dispatch")
    _same(sh, single, "elastic, two devices")
    assert int(single.scaler.up_count.sum()) > 0
    assert float(single.scaler.spot_cost.sum()) > 0.0
    grid = sweep.policy_points(util_highs=(0.55, 0.72), util_lows=(0.18,),
                               cooldowns=(2.0,), device=CPU)
    _same(sweep.run_policy_search(batch, grid, max_steps=512, devices=TWO,
                                  partitioner="dispatch"),
          sweep.run_policy_search(batch, grid, max_steps=512),
          "policy search, two devices")


def test_elasticity_study_over_two_devices_bitwise():
    _, batch = _elastic()
    grid = sweep.policy_points(util_highs=(0.6,), util_lows=(0.2,),
                               cooldowns=(1.0, 3.0), device=CPU)
    a = X.run_elasticity_study(batch, grid, max_steps=512)
    b = X.run_elasticity_study(batch, grid, max_steps=512, devices=TWO,
                               partitioner="dispatch")
    _same(b.final, a.final, "elasticity study, two devices")
    np.testing.assert_array_equal(b.pareto, a.pareto)
    assert torch.equal(b.sla, a.sla) and torch.equal(b.cost, a.cost)


def test_run_sharded_one_device_metrics_bitwise():
    _, batch = _metric_batch()
    ref = sweep.run_batch(batch, max_steps=512)
    out = sweep.run_sharded(batch, devices=[CPU], max_steps=512,
                            partitioner="dispatch")
    _same(out.metrics, ref.metrics, "dispatch metrics")


def test_sharded_two_devices_metrics_bitwise():
    _, batch = _metric_batch()
    vm_p, task_p = sweep.policy_grid(device=CPU)
    single = sweep.run_grid(batch, vm_p, task_p, max_steps=512,
                            sharded=False)
    out = sweep.run_grid(batch, vm_p, task_p, max_steps=512, devices=TWO,
                         partitioner="dispatch")
    _same(out.metrics, single.metrics, "two-device metrics")
    assert int(single.metrics.hist_response.sum()) > 0


# ---------------------------------------------------------------------------
# tests/test_streaming.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("devices", [[CPU], TWO, [CPU] * 3])
def test_stream_sharded_bitwise(monkeypatch, devices):
    """The one batch a list of one distinct device runs, and contiguous
    blocks a device (reached here by turning the one-batch rule off),
    the lane count padded with inert stream lanes (3 lanes over 2
    devices), == the plain batch."""
    dcs = [_infra(8) for _ in range(3)]
    streams = [_random_stream(s, n=30, chunk=16) for s in range(3)]
    batch = sweep.stack_scenarios(dcs)
    a = sweep.run_stream_batch(batch, streams)
    vp, tp = sweep.policy_grid(device=CPU)
    grid = sweep.run_stream_grid(batch, streams, vp[:2], tp[:2])
    for route in ("one batch", "blocks"):
        if route == "blocks":
            monkeypatch.setattr(sweep, "_one_batch", lambda *a: False)
        b = sweep.run_stream_batch(batch, streams, devices=devices)
        _same(a, b, f"streamed lanes over {len(devices)} devices, {route}")
        _same(sweep.run_stream_grid(batch, streams, vp[:2], tp[:2],
                                    devices=devices),
              grid, f"streamed grid, {route}")


# ---------------------------------------------------------------------------
# "auto" on one distinct device runs one batch; "dispatch" cuts chunks
# ---------------------------------------------------------------------------
def _count_calls(monkeypatch, name):
    """Count the calls the sweep makes to ``engine.<name>``."""
    calls = []
    real = getattr(E, name)

    def counted(*args, **kwargs):
        calls.append(args[0].time.shape[0])
        return real(*args, **kwargs)
    monkeypatch.setattr(E, name, counted)
    return calls


@pytest.mark.parametrize("devices", [[CPU], TWO, [CPU] * 3])
def test_auto_on_one_device_runs_one_batch(monkeypatch, devices):
    """A list naming one device (once or more) under ``"auto"`` makes one
    ``batched_run`` of every lane, as JAX keeps the fused program on a
    one-device mesh; ``"dispatch"`` makes one a chunk of 4.  Both equal
    ``run_batch`` bit for bit."""
    _, batch = _static(5)
    vm_p, task_p = sweep.policy_grid(device=CPU)
    fused = sweep.fuse_grid(batch, vm_p, task_p)
    ref = sweep.run_batch(fused, max_steps=256)
    calls = _count_calls(monkeypatch, "batched_run")
    out = sweep.run_sharded(fused, devices=devices, max_steps=256)
    assert calls == [20]
    _same(out, ref, "auto")
    calls.clear()
    out = sweep.run_sharded(fused, devices=devices, max_steps=256,
                            partitioner="dispatch")
    assert calls == [4] * 5
    _same(out, ref, "dispatch")
    calls.clear()
    grid = sweep.run_grid(batch, vm_p, task_p, max_steps=256,
                          devices=devices)
    assert calls == [20]
    _same(grid, sweep._unfuse(ref, 4), "run_grid, auto")
    _, ebatch = _elastic()
    points = sweep.policy_points(util_highs=(0.6,), util_lows=(0.2,),
                                 cooldowns=(1.0, 3.0), device=CPU)
    calls.clear()
    sweep.run_policy_search(ebatch, points, max_steps=512, devices=devices)
    assert calls == [6]


def test_auto_streamed_on_one_device_runs_one_batch(monkeypatch):
    """The stream runners: [cpu, cpu] makes one ``batched_run_stream``;
    with the one-batch rule off, one a listed device."""
    dcs = [_infra(8) for _ in range(3)]
    streams = [_random_stream(s, n=30, chunk=16) for s in range(3)]
    batch = sweep.stack_scenarios(dcs)
    calls = _count_calls(monkeypatch, "batched_run_stream")
    sweep.run_stream_batch(batch, streams, devices=TWO)
    assert calls == [3]
    calls.clear()
    monkeypatch.setattr(sweep, "_one_batch", lambda *a: False)
    sweep.run_stream_batch(batch, streams, devices=TWO)
    assert calls == [2, 2]


def test_distinct_devices_and_one_batch():
    assert sweep._distinct([torch.device(CPU)] * 3) == 1
    assert sweep._one_batch("auto", [torch.device(CPU)] * 2)
    assert not sweep._one_batch("dispatch", [torch.device(CPU)])


# ---------------------------------------------------------------------------
# The SPMD partitioners over a device list, and the dispatcher's order
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("partitioner", ["gspmd", "shard_map", "pjit"])
def test_spmd_partitioners_raise(partitioner):
    _, batch = _static(1)
    with pytest.raises(ValueError, match=partitioner):
        sweep.run_sharded(batch, devices=[CPU], partitioner=partitioner)
    vm_p, task_p = sweep.policy_grid(device=CPU)
    with pytest.raises(ValueError, match=partitioner):
        sweep.run_grid(batch, vm_p, task_p, devices=[CPU],
                       partitioner=partitioner)


def test_default_devices_are_the_card(monkeypatch):
    """No devices given means the CUDA card; without one the dispatcher
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, batch = _static(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.run_sharded(batch)
    vm_p, task_p = sweep.policy_grid(device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.run_grid(batch, vm_p, task_p, sharded=True)


def test_dispatch_cost_and_order_match_jax():
    """The per-lane estimate equals JAX's ``_dispatch_cost``, so the
    stable descending sort deals the same chunks."""
    jdcs = ([make_scenario(s, *POLICY_GRID[s % 4]) for s in range(3)]
            + [make_dynamic_scenario(s, 0, 0) for s in (0, 1)]
            + [make_networked_scenario(2, 0, 1)])
    jbatch = JSW.stack_scenarios(jdcs)
    want = JSW._dispatch_cost(jbatch)
    got = sweep._dispatch_cost(_port(jbatch))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.argsort(-got, kind="stable"),
                                  np.argsort(-want, kind="stable"))
    assert len(set(got.tolist())) > 1
