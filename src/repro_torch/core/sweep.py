"""Batched scenario sweeps (``repro.core.sweep`` in PyTorch, one device).

Every field of ``DatacenterState`` is a dense tensor, so B independent
scenarios stack into a leading lane axis and ``engine.batched_run`` runs
them together: each pass (sorts, sums, the simstep kernel) runs once
for all lanes, and lane i gives the same bits as ``engine.run`` of its
scenario alone.

The policy grid is *fused* into the lane axis: ``run_grid`` broadcasts
each of the P policy pairs over the B stacked scenarios into P*B lanes
(lane ``p*B + b`` is scenario ``b`` under pair ``p``), runs them in one
``batched_run`` and reshapes the result to [P, B, ...].
``run_grid_nested`` runs one ``run_batch`` a policy pair instead, kept
as the differential baseline.

Ragged scenarios are padded to a common shape first: padded hosts are
invalid, padded VMs ``VM_EMPTY``, padded cloudlets ``CL_EMPTY`` (with
``vm = -1``), so padding is inert and a padded lane reproduces its
unpadded run on the real slots.  ``pad_batch`` pads the lane axis with
whole inert scenarios, which quiesce on their first step.

Streamed lanes (``run_stream_batch``, ``run_stream_grid``) stack their
arrival queues to one [B, K, M] table (``stack_streams``, which pads
ragged chunk counts with all-padding chunks) and run through
``engine.batched_run_stream``: one admission pass and one simstep
launch a full step for every lane.

The autoscaler policy search (``run_policy_search``) fuses P
autoscaler points (``policy_points``) into the lane axis the same way
(``fuse_policies``), for ``experiments.run_elasticity_study``.

The lane dispatcher (``run_sharded``, and the ``devices`` arguments of
``run_grid``, ``run_policy_search`` and the stream runners) splits the
lane axis over a list of devices, where the JAX package splits it over
a mesh: the lanes, sorted by an estimate of their cost, go out in
chunks of four, round-robin, one ``batched_run`` a chunk, and come back
in lane order on ``devices[0]`` (the stream runners cut one contiguous
block a device instead).  A list may name one card twice.  With
``partitioner="auto"`` (the default) a list of one distinct device runs
the whole batch as one ``batched_run`` there, as a one-device JAX mesh
keeps the fused program; ``"dispatch"`` always cuts, even on one card,
where the pieces run one after another.  The stream runners take no
partitioner and always follow the one-distinct-device rule.  Every
spelling equals ``run_batch`` bit for bit, because lane i equals its
single run.

Over ranks (``run_sharded(mesh=...)``, ``run_grid(mesh=...)``), the lane
axis is split over a live 1-D ``launch.mesh.Mesh`` of processes (NCCL
on cards, gloo on the CPU), where JAX builds one SPMD program over a
1-D device mesh.  The lanes are padded to a multiple of the world with
inert lanes; each rank runs its contiguous block (``"gspmd"``, or
``"shard_map"`` with ``inner="vmap"``: one ``batched_run``;
``"shard_map"`` with ``inner="map"``: one ``engine.run`` a lane); the
blocks are all-gathered leaf by leaf through the mesh, so every rank
holds the whole result, as JAX's lane-sharded output is one global
array; then the padding is cut.  ``"auto"`` with a mesh is
``"shard_map"`` with ``inner="vmap"``, JAX's choice on an accelerator
backend.  No lane's arithmetic depends on which rank runs it, so every
spelling equals ``run_batch`` bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.energy import energy_total_j
from repro_torch.core.provisioning import FIRST_FIT
from repro_torch.core.state import (CL_CREATED, CL_DONE, CL_EMPTY, INF,
                                    VM_EMPTY, VM_PENDING, ArrivalStream,
                                    DatacenterState, StreamState,
                                    map_tensors, tensor_leaves, to_device,
                                    with_leaves)
from repro_torch.core.streaming import StreamChunkRecord
from repro_torch.device import resolve_device

__all__ = ["pad_scenario", "stack_scenarios", "run_batch", "run_grid",
           "run_grid_nested", "fuse_grid", "inert_lane", "pad_batch",
           "run_sharded", "policy_grid", "SweepSummary", "summarize_batch",
           "stack_streams", "inert_stream_lane", "run_stream_batch",
           "run_stream_grid", "StreamSweepSummary", "summarize_stream",
           "PolicyGrid", "policy_points", "fuse_policies",
           "run_policy_search", "gather_lanes"]


# ---------------------------------------------------------------------------
# Padding + stacking
# ---------------------------------------------------------------------------
def _pad_axis0(t: torch.Tensor, n: int, fill) -> torch.Tensor:
    extra = n - t.shape[0]
    if extra < 0:
        raise ValueError(f"cannot shrink axis 0: {t.shape[0]} -> {n}")
    if extra == 0:
        return t
    if not isinstance(fill, torch.Tensor):
        fill = torch.tensor(fill, dtype=t.dtype, device=t.device)
    return torch.cat([t, fill.to(t.dtype).expand((extra,) + t.shape[1:])])


def pad_scenario(dc: DatacenterState, *, n_hosts: int | None = None,
                 n_vms: int | None = None, n_cloudlets: int | None = None,
                 n_events: int | None = None,
                 n_spot: int | None = None) -> DatacenterState:
    """Grow a scenario to fixed entity capacities with inert padding.

    Padded event rows are all-zero (kind ``EV_NONE``) and unfired.  Spot
    tables pad with duplicates of their final segment, which add no
    boundary and keep the active segment's price.
    """
    h, v, c = dc.hosts, dc.vms, dc.cloudlets
    nh = n_hosts if n_hosts is not None else h.num_pes.shape[0]
    nv = n_vms if n_vms is not None else v.req_pes.shape[0]
    nc = n_cloudlets if n_cloudlets is not None else c.vm.shape[0]
    ne = n_events if n_events is not None else dc.events.shape[0]
    sc = dc.scaler
    ns = n_spot if n_spot is not None else sc.spot_t.shape[0]

    # every host, VM and cloudlet field, with its inert fill
    host_fill = dict(valid=False)
    vm_fill = dict(host=-1, state=VM_EMPTY, create_time=INF)
    cl_fill = dict(vm=-1, start_time=-1.0, finish_time=INF, state=CL_EMPTY)
    pad = lambda blk, n, fills: dataclasses.replace(blk, **{
        f.name: _pad_axis0(getattr(blk, f.name), n, fills.get(f.name, 0))
        for f in dataclasses.fields(blk)})
    return dataclasses.replace(
        dc, hosts=pad(h, nh, host_fill), vms=pad(v, nv, vm_fill),
        cloudlets=pad(c, nc, cl_fill),
        events=_pad_axis0(dc.events, ne, 0.0),
        event_fired=_pad_axis0(dc.event_fired, ne, False),
        net=dataclasses.replace(
            dc.net, cluster=_pad_axis0(dc.net.cluster, nh, 0)),
        scaler=dataclasses.replace(
            sc, spot_t=_pad_axis0(sc.spot_t, ns, sc.spot_t[-1]),
            spot_price=_pad_axis0(sc.spot_price, ns, sc.spot_price[-1])),
        metrics=dataclasses.replace(
            dc.metrics,
            host_busy_s=_pad_axis0(dc.metrics.host_busy_s, nh, 0.0)))


def _stack(states: Sequence[DatacenterState]) -> DatacenterState:
    leaves = zip(*(tensor_leaves(d) for d in states))
    return with_leaves(states[0], [torch.stack(ts) for ts in leaves])


def stack_scenarios(dcs: Sequence[DatacenterState]) -> DatacenterState:
    """Stack scenarios into one batched state (leading axis B), padding
    every entity block to the sweep-wide maximum capacity."""
    if not dcs:
        raise ValueError("empty scenario list")
    cap = dict(
        n_hosts=max(d.hosts.num_pes.shape[0] for d in dcs),
        n_vms=max(d.vms.req_pes.shape[0] for d in dcs),
        n_cloudlets=max(d.cloudlets.vm.shape[0] for d in dcs),
        n_events=max(d.events.shape[0] for d in dcs),
        n_spot=max(d.scaler.spot_t.shape[0] for d in dcs))
    return _stack([pad_scenario(d, **cap) for d in dcs])


def inert_lane(batch: DatacenterState) -> DatacenterState:
    """One unbatched scenario that quiesces on its first step: every host
    invalid, every VM ``VM_EMPTY``, every cloudlet ``CL_EMPTY``."""
    lane = map_tensors(lambda t: torch.zeros_like(t[0]), batch)
    full = lambda t, x: torch.full_like(t, x)
    return dataclasses.replace(
        lane,
        vms=dataclasses.replace(
            lane.vms, host=full(lane.vms.host, -1),
            state=full(lane.vms.state, VM_EMPTY),
            create_time=full(lane.vms.create_time, INF)),
        cloudlets=dataclasses.replace(
            lane.cloudlets, vm=full(lane.cloudlets.vm, -1),
            start_time=full(lane.cloudlets.start_time, -1.0),
            finish_time=full(lane.cloudlets.finish_time, INF),
            state=full(lane.cloudlets.state, CL_EMPTY)))


def pad_batch(batch: DatacenterState, n_lanes: int) -> DatacenterState:
    """Grow the leading lane axis to ``n_lanes`` with inert lanes."""
    have = batch.time.shape[0]
    if n_lanes < have:
        raise ValueError(f"cannot shrink lane axis: {have} -> {n_lanes}")
    if n_lanes == have:
        return batch
    pad = tensor_leaves(inert_lane(batch))
    return with_leaves(batch, [
        torch.cat([x, p[None].expand((n_lanes - have,) + p.shape)])
        for x, p in zip(tensor_leaves(batch), pad)])


def policy_grid(*, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The paper's full 2x2 (vm_policy, task_policy) matrix, paired."""
    vm_p = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=device)
    task_p = torch.tensor([0, 1, 0, 1], dtype=torch.int32, device=device)
    return vm_p, task_p


def _policies(batch, vm_policies, task_policies):
    dev = batch.time.device
    vm_p = torch.as_tensor(vm_policies, dtype=torch.int32, device=dev)
    task_p = torch.as_tensor(task_policies, dtype=torch.int32, device=dev)
    if vm_p.shape != task_p.shape or vm_p.ndim != 1:
        raise ValueError("vm_policies and task_policies must pair up: "
                         f"{tuple(vm_p.shape)} vs {tuple(task_p.shape)}")
    return vm_p, task_p


def fuse_grid(batch: DatacenterState, vm_policies, task_policies
              ) -> DatacenterState:
    """Flatten a [B] scenario batch x i32[P] policy pairs into [P*B] lanes.

    Lane ``p*B + b`` is scenario ``b`` with its ``vm_policy``/
    ``task_policy`` overwritten by pair ``p``; every other leaf is
    repeated.  The inverse is a reshape of each leaf to ``(P, B) +
    rest``.
    """
    vm_p, task_p = _policies(batch, vm_policies, task_policies)
    n_pol, n_scen = vm_p.shape[0], batch.time.shape[0]
    fused = map_tensors(lambda x: x[None].expand(
        (n_pol,) + x.shape).reshape((n_pol * n_scen,) + x.shape[1:]), batch)
    return dataclasses.replace(
        fused, vm_policy=vm_p.repeat_interleave(n_scen),
        task_policy=task_p.repeat_interleave(n_scen))


# ---------------------------------------------------------------------------
# Batched runners
# ---------------------------------------------------------------------------
def run_batch(batch: DatacenterState, *, max_steps: int = 1_000_000,
              provision_policy: int = FIRST_FIT, leap: bool | None = None
              ) -> DatacenterState:
    """Run a stacked scenario batch, every lane to its own quiescence
    (``engine.batched_run``); lane i equals the single ``engine.run`` of
    its scenario bit for bit."""
    return engine.batched_run(batch, max_steps=max_steps,
                              provision_policy=provision_policy, leap=leap)


def _unfuse(out: DatacenterState, n_pol: int) -> DatacenterState:
    return map_tensors(
        lambda x: x.reshape((n_pol, x.shape[0] // n_pol) + x.shape[1:]), out)


def run_grid(batch: DatacenterState, vm_policies, task_policies, *,
             max_steps: int = 1_000_000, provision_policy: int = FIRST_FIT,
             leap: bool | None = None, devices=None, mesh=None,
             sharded: bool | None = None,
             partitioner: str = "auto") -> DatacenterState:
    """Scenarios x policy grid as ONE fused batch: ``fuse_grid``, then
    ``engine.batched_run``, then a reshape to a [P, B, ...] final state.

    ``vm_policies``/``task_policies`` are i32[P], paired (the 2x2
    Figure 3 matrix is P = 4, ``policy_grid``).  With ``sharded`` (the
    default when ``devices`` or ``mesh`` is given) the fused lanes go
    through ``run_sharded`` over ``devices``, or over the ranks of
    ``mesh`` (JAX's ``_grid_runner``; every rank gets the whole grid).
    Every lane equals the single ``engine.run`` of its cell and
    ``run_grid_nested``, bit for bit, whichever the spelling.
    """
    vm_p, task_p = _policies(batch, vm_policies, task_policies)
    if sharded is None:
        sharded = devices is not None or mesh is not None
    fused = fuse_grid(batch, vm_p, task_p)
    if sharded:
        out = run_sharded(fused, devices=devices, mesh=mesh,
                          max_steps=max_steps,
                          provision_policy=provision_policy,
                          partitioner=partitioner, leap=leap)
    else:
        out = engine.batched_run(fused, max_steps=max_steps,
                                 provision_policy=provision_policy,
                                 leap=leap)
    return _unfuse(out, vm_p.shape[0])


def run_grid_nested(batch: DatacenterState, vm_policies, task_policies, *,
                    max_steps: int = 1_000_000,
                    provision_policy: int = FIRST_FIT,
                    leap: bool | None = None) -> DatacenterState:
    """Reference grid runner: one ``run_batch`` a policy pair, stacked to
    the same [P, B, ...] layout as ``run_grid`` (the differential
    baseline for the fused path)."""
    vm_p, task_p = _policies(batch, vm_policies, task_policies)
    n_scen = batch.time.shape[0]
    outs = []
    for vp, tp in zip(vm_p, task_p):
        cell = dataclasses.replace(batch, vm_policy=vp.expand(n_scen),
                                   task_policy=tp.expand(n_scen))
        outs.append(run_batch(cell, max_steps=max_steps,
                              provision_policy=provision_policy, leap=leap))
    return _stack(outs)


# ---------------------------------------------------------------------------
# The lane dispatcher: the lane axis over a list of devices
# ---------------------------------------------------------------------------
def _devices(devices) -> list[torch.device]:
    """``devices`` as a list of ``torch.device``; ``None`` is the card."""
    if devices is None:
        return [resolve_device()]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("devices is empty")
    return devs


def _distinct(devices: list[torch.device]) -> int:
    """How many different devices ``devices`` names (``cuda`` and the
    current ``cuda:i`` are one)."""
    key = lambda d: (torch.device("cuda", torch.cuda.current_device())
                     if d.type == "cuda" and d.index is None else d)
    return len({key(d) for d in devices})


def _one_batch(partitioner: str, devices: list[torch.device]) -> bool:
    """``"auto"`` over one distinct device runs the batch whole."""
    return partitioner == "auto" and _distinct(devices) == 1


def _check_partitioner(partitioner: str) -> None:
    """``"auto"`` (one batch on one distinct device, else the dispatcher)
    and ``"dispatch"`` (always the dispatcher)."""
    if partitioner in ("gspmd", "shard_map"):
        raise ValueError(
            f"partitioner {partitioner!r} splits the lanes over the ranks "
            "of a mesh (run_sharded(mesh=...)), not over a device list; "
            "use 'dispatch' (or 'auto')")
    if partitioner not in ("auto", "dispatch"):
        raise ValueError(f"unknown partitioner: {partitioner!r}")


def _dispatch_cost(batch: DatacenterState) -> np.ndarray:
    """Host-side estimate of each lane's step count, to order the chunks:
    CREATED cloudlets, twice the pending VMs, four times the unfired
    event rows, all four times over under a migration policy.  Only the
    order depends on it, never a lane's result."""
    count = lambda m: m.sum(dim=-1).cpu().numpy().astype(np.float64)
    est = count(batch.cloudlets.state == CL_CREATED)
    est += 2.0 * count(batch.vms.state == VM_PENDING)
    if batch.events.shape[-2]:
        kinds = batch.events[..., 1].to(torch.int32)
        est += 4.0 * count(~batch.event_fired & (kinds != 0))
    est *= np.where(batch.mig_policy.cpu().numpy() != 0, 4.0, 1.0)
    return est


def _take(tree, idx: torch.Tensor, device):
    return map_tensors(lambda x: x[idx.to(x.device)].to(device), tree)


def _cat(parts, device):
    return with_leaves(parts[0], [
        torch.cat([x.to(device) for x in xs])
        for xs in zip(*(tensor_leaves(p) for p in parts))])


def _dispatch_run(batch: DatacenterState, devices, *, max_steps: int,
                  provision_policy: int, leap: bool | None,
                  chunk: int = 4) -> DatacenterState:
    """Sorted-chunk dispatch: lanes sorted by ``_dispatch_cost``,
    descending and stable, cut into chunks of ``chunk`` lanes dealt
    round-robin over ``devices``, one ``engine.batched_run`` a chunk, so
    each chunk retires at its own slowest lane; the results come back in
    lane order on ``devices[0]``."""
    order = np.argsort(-_dispatch_cost(batch), kind="stable")
    outs = []
    for i in range(0, order.size, chunk):
        dev = devices[(i // chunk) % len(devices)]
        sub = _take(batch, torch.from_numpy(order[i:i + chunk]), dev)
        outs.append(engine.batched_run(sub, max_steps=max_steps,
                                       provision_policy=provision_policy,
                                       leap=leap))
    inv = torch.from_numpy(np.argsort(order, kind="stable"))
    return _take(_cat(outs, devices[0]), inv, devices[0])


def _lane_axis(mesh) -> str:
    """The (only) axis name of a 1-D sweep mesh; reject higher ranks."""
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"sweep meshes are 1-D; got axes {mesh.axis_names}")
    return mesh.axis_names[0]


def _mesh_partitioner(partitioner: str, inner: str | None) -> str:
    """The per-rank scheme of the mesh form: "vmap" (one
    ``batched_run``) or "map" (one ``engine.run`` a lane)."""
    if partitioner == "auto":
        partitioner = "shard_map"
    if partitioner == "gspmd":
        return "vmap"
    if partitioner != "shard_map":
        raise ValueError(f"partitioner {partitioner!r} over a mesh: "
                         f"'shard_map', 'gspmd' or 'auto'")
    inner = inner or "vmap"
    if inner not in ("vmap", "map"):
        raise ValueError(f"unknown inner: {inner!r}")
    return inner


def gather_lanes(tree, mesh, axis: str):
    """Every rank's block of a state (or any block of one) along the
    lane axis, all-gathered leaf by leaf over ``axis`` in rank order.
    Each leaf travels as its bytes (any dtype; the copies are exact);
    a leaf with no elements is not sent."""
    n = mesh.axis_size(axis)

    def leaf(x):
        if x.numel() == 0:
            return x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        raw = x.clone(memory_format=torch.contiguous_format).view(
            torch.uint8)
        return mesh.all_gather(raw, axis, dim=0).view(x.dtype)
    return map_tensors(leaf, tree)


def _run_on_mesh(batch: DatacenterState, mesh, *, scheme: str,
                 max_steps: int, provision_policy: int,
                 leap: bool | None) -> DatacenterState:
    """This rank's contiguous block of the padded lanes, run by
    ``scheme``, then every block gathered and the padding cut."""
    axis = _lane_axis(mesh)
    n = mesh.axis_size(axis)
    have = batch.time.shape[0]
    per = -(-have // n)
    padded = pad_batch(batch, per * n)
    lo = mesh.axis_index(axis) * per
    block = to_device(map_tensors(lambda x: x[lo:lo + per], padded),
                      mesh.device)
    kw = dict(max_steps=max_steps, provision_policy=provision_policy,
              leap=leap)
    if scheme == "vmap":
        out = engine.batched_run(block, **kw)
    else:
        out = _stack([engine.run(map_tensors(lambda x: x[i], block), **kw)
                      for i in range(per)])
    out = gather_lanes(out, mesh, axis)
    return map_tensors(lambda x: x[:have], out)


def run_sharded(batch: DatacenterState, *, devices=None, mesh=None,
                max_steps: int = 1_000_000,
                provision_policy: int = FIRST_FIT,
                partitioner: str = "auto", inner: str | None = None,
                leap: bool | None = None) -> DatacenterState:
    """``run_batch`` with the lane axis split over ``devices`` or over
    the ranks of ``mesh``; the result equals ``run_batch`` bit for bit.

    ``devices`` (a list of devices, which may name one card twice;
    default the card): the sorted-chunk dispatcher (``_dispatch_run``).
    ``partitioner`` is ``"dispatch"`` (always the dispatcher) or
    ``"auto"`` (one ``batched_run`` on ``devices[0]`` when the list
    names one distinct device, the dispatcher otherwise); ``"gspmd"``
    and ``"shard_map"`` over a device list raise ``ValueError``.  The
    result lies on ``devices[0]``.

    ``mesh`` (a live 1-D ``launch.mesh.Mesh``, JAX's sweep mesh): each
    rank runs its contiguous block of lanes (see the module's
    docstring) with ``partitioner`` ``"shard_map"`` (``inner`` "vmap",
    the default, or "map"), ``"gspmd"`` or ``"auto"`` (``"shard_map"``);
    every rank gets the whole result, on its own device."""
    if mesh is not None:
        if devices is not None:
            raise ValueError("run_sharded takes devices or a mesh, not "
                             "both")
        return _run_on_mesh(batch, mesh,
                            scheme=_mesh_partitioner(partitioner, inner),
                            max_steps=max_steps,
                            provision_policy=provision_policy, leap=leap)
    _check_partitioner(partitioner)
    devs = _devices(devices)
    if _one_batch(partitioner, devs):
        return engine.batched_run(to_device(batch, devs[0]),
                                  max_steps=max_steps,
                                  provision_policy=provision_policy,
                                  leap=leap)
    return _dispatch_run(batch, devs, max_steps=max_steps,
                         provision_policy=provision_policy, leap=leap)


# ---------------------------------------------------------------------------
# Autoscaler policy search: P (watermark, cooldown, step, price) points
# x B scenarios as one flat elastic lane axis
# ---------------------------------------------------------------------------
class PolicyGrid(NamedTuple):
    """P autoscaler policy points, paired element-wise.  Only the
    searchable knobs live here; fleet bounds and spot tables stay per
    scenario on the batch."""
    util_high: torch.Tensor          # f32[P] scale-up watermark
    util_low: torch.Tensor           # f32[P] scale-down watermark
    cooldown: torch.Tensor           # f32[P] min seconds between actions
    scale_step: torch.Tensor         # i32[P] VMs per action
    price_sensitivity: torch.Tensor  # f32[P] spot price ceiling (0 = off)


def policy_points(util_highs: Sequence[float], util_lows: Sequence[float],
                  cooldowns: Sequence[float],
                  price_sensitivities: Sequence[float] = (0.0,),
                  scale_steps: Sequence[int] = (1,), *,
                  device=None) -> PolicyGrid:
    """Cartesian product of the knob axes, dropping inverted watermark
    pairs (``util_low >= util_high``)."""
    pts = [(uh, ul, cd, ps, ss)
           for uh in util_highs
           for ul in util_lows if ul < uh
           for cd in cooldowns
           for ps in price_sensitivities
           for ss in scale_steps]
    if not pts:
        raise ValueError("empty policy grid (check watermark ordering)")
    uh, ul, cd, ps, ss = zip(*pts)
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
    return PolicyGrid(util_high=f32(uh), util_low=f32(ul), cooldown=f32(cd),
                      scale_step=torch.tensor(np.asarray(ss, np.int32),
                                              device=device),
                      price_sensitivity=f32(ps))


def fuse_policies(batch: DatacenterState, grid: PolicyGrid
                  ) -> DatacenterState:
    """Flatten a [B] batch x P autoscaler points into [P*B] elastic lanes:
    lane ``p*B + b`` is scenario ``b`` with its scaler's searchable knobs
    set to point ``p`` and the loop enabled."""
    n_pol = grid.util_high.shape[0]
    n_scen = batch.time.shape[0]
    dev = batch.time.device
    fused = map_tensors(lambda x: x[None].expand(
        (n_pol,) + x.shape).reshape((n_pol * n_scen,) + x.shape[1:]), batch)
    rep = lambda x: x.to(dev).repeat_interleave(n_scen)
    return dataclasses.replace(
        fused,
        scaler=dataclasses.replace(
            fused.scaler,
            enabled=torch.ones((n_pol * n_scen,), dtype=torch.int32,
                               device=dev),
            util_high=rep(grid.util_high), util_low=rep(grid.util_low),
            cooldown=rep(grid.cooldown), scale_step=rep(grid.scale_step),
            price_sensitivity=rep(grid.price_sensitivity)))


def run_policy_search(batch: DatacenterState, grid: PolicyGrid, *,
                      max_steps: int = 1_000_000,
                      provision_policy: int = FIRST_FIT,
                      leap: bool | None = None, devices=None,
                      partitioner: str = "auto") -> DatacenterState:
    """Every (scenario, autoscaler point) cell in one elastic batch
    (``fuse_policies``, then ``engine.batched_run``, or ``run_sharded``
    over ``devices`` with ``partitioner`` when given), reshaped to
    ``[P, B, ...]``; each cell equals the single ``engine.run`` of its
    scenario with those knobs, bit for bit."""
    fused = fuse_policies(batch, grid)
    if devices is None:
        out = engine.batched_run(fused, max_steps=max_steps,
                                 provision_policy=provision_policy,
                                 leap=leap)
    else:
        out = run_sharded(fused, devices=devices, max_steps=max_steps,
                          provision_policy=provision_policy,
                          partitioner=partitioner, leap=leap)
    return _unfuse(out, grid.util_high.shape[0])


# ---------------------------------------------------------------------------
# Streamed (windowed) lanes
# ---------------------------------------------------------------------------
def stack_streams(streams: Sequence[ArrivalStream]) -> ArrivalStream:
    """Stack per-lane arrival queues into one [B, K, M] table.

    Every stream must share the chunk width M; ragged chunk counts are
    padded with all-padding chunks (``vm = -1``, ``submit = INF``),
    whose records repeat the last chunk's final counts with no events,
    as the JAX engine's one inactive step a chunk gives them.
    """
    if not streams:
        raise ValueError("empty stream list")
    ms = {s.vm.shape[1] for s in streams}
    if len(ms) != 1:
        raise ValueError(f"streams must share a chunk width; got {ms}")
    kmax = max(s.vm.shape[0] for s in streams)
    fills = dict(vm=-1, submit=INF)

    def grow(s: ArrivalStream) -> ArrivalStream:
        return dataclasses.replace(s, **{
            f.name: _pad_axis0(getattr(s, f.name), kmax,
                               fills.get(f.name, 0))
            for f in dataclasses.fields(s)})

    return _stack([grow(s) for s in streams])


def inert_stream_lane(streams: ArrivalStream) -> ArrivalStream:
    """One unbatched arrival queue of the width of ``streams``' with no
    arrival: beside ``inert_lane``, a padded lane that commits nothing."""
    lane = map_tensors(lambda t: torch.zeros_like(t[0]), streams)
    return dataclasses.replace(lane, vm=torch.full_like(lane.vm, -1),
                               submit=torch.full_like(lane.submit, INF))


def run_stream_batch(batch: DatacenterState,
                     streams: ArrivalStream | Sequence[ArrivalStream], *,
                     reservoir: int = 64, provision_policy: int = FIRST_FIT,
                     leap: bool | None = None,
                     max_steps_per_chunk: int = 4096, devices=None
                     ) -> tuple[DatacenterState, StreamState,
                                StreamChunkRecord]:
    """``engine.run_stream`` over stacked windowed lanes.

    ``batch`` is a stacked scenario batch whose cloudlet blocks are
    windows (``state.make_window``); ``streams`` a stacked [B, K, M]
    table, or a sequence that ``stack_streams`` stacks.  Each lane admits
    and retires on its own; lane i equals ``engine.run_stream`` of its
    scenario bit for bit.  ``devices`` (a list) splits the lanes into one
    contiguous block a device, the lane count padded to a multiple of
    the devices with inert stream lanes, as the JAX package's mesh path
    does; the result lies on ``devices[0]``, unpadded.  A list of one
    distinct device runs the whole batch there, as a one-device mesh
    does.
    """
    if not isinstance(streams, ArrivalStream):
        streams = stack_streams(list(streams))
    kw = dict(reservoir=reservoir, provision_policy=provision_policy,
              leap=leap, max_steps_per_chunk=max_steps_per_chunk)
    if devices is None:
        return engine.batched_run_stream(batch, streams, **kw)[:3]
    devs = _devices(devices)
    if _one_batch("auto", devs):
        return engine.batched_run_stream(to_device(batch, devs[0]),
                                         to_device(streams, devs[0]),
                                         **kw)[:3]
    have = batch.time.shape[0]
    per = -(-have // len(devs))
    lanes = per * len(devs)
    if lanes != have:
        batch = pad_batch(batch, lanes)
        pad = tensor_leaves(inert_stream_lane(streams))
        streams = with_leaves(streams, [
            torch.cat([x, p[None].expand((lanes - have,) + p.shape)])
            for x, p in zip(tensor_leaves(streams), pad)])
    outs = []
    for k, dev in enumerate(devs):
        block = lambda t: to_device(
            map_tensors(lambda x: x[k * per:(k + 1) * per], t), dev)
        outs.append(engine.batched_run_stream(block(batch), block(streams),
                                              **kw))
    home = devs[0]
    cut = lambda t: map_tensors(lambda x: x[:have], t)
    recs = StreamChunkRecord(*(torch.cat([r.to(home) for r in col])[:have]
                               for col in zip(*(o[2] for o in outs))))
    return (cut(_cat([o[0] for o in outs], home)),
            cut(_cat([o[1] for o in outs], home)), recs)


def run_stream_grid(batch: DatacenterState,
                    streams: ArrivalStream | Sequence[ArrivalStream],
                    vm_policies, task_policies, *, reservoir: int = 64,
                    provision_policy: int = FIRST_FIT,
                    leap: bool | None = None,
                    max_steps_per_chunk: int = 4096, devices=None
                    ) -> tuple[DatacenterState, StreamState,
                               StreamChunkRecord]:
    """Streamed scenarios x policy grid as one fused [P*B] batch
    (``fuse_grid`` for the states, a tile for the queues, which carry no
    policy), reshaped to [P, B, ...]; ``devices`` as in
    ``run_stream_batch``."""
    if not isinstance(streams, ArrivalStream):
        streams = stack_streams(list(streams))
    vm_p, task_p = _policies(batch, vm_policies, task_policies)
    n_pol = vm_p.shape[0]
    tile = lambda x: x[None].expand((n_pol,) + x.shape).reshape(
        (n_pol * x.shape[0],) + x.shape[1:])
    out = run_stream_batch(
        fuse_grid(batch, vm_p, task_p), map_tensors(tile, streams),
        reservoir=reservoir, provision_policy=provision_policy, leap=leap,
        max_steps_per_chunk=max_steps_per_chunk, devices=devices)
    recs = StreamChunkRecord(*(r.reshape((n_pol, -1) + r.shape[1:])
                               for r in out[2]))
    return _unfuse(out[0], n_pol), _unfuse(out[1], n_pol), recs


class StreamSweepSummary(NamedTuple):
    """Per-lane scalars of streamed sweeps (from ``StreamStats``)."""
    n_retired: torch.Tensor       # i32[...]  cloudlets folded out DONE
    n_failed: torch.Tensor        # i32[...]  dead-VM / failed arrivals
    makespan: torch.Tensor        # f32[...]  latest completion, s
    mean_response: torch.Tensor   # f32[...]  mean finish - submit over done
    sum_len: torch.Tensor         # f32[...]  MI completed
    peak_occupancy: torch.Tensor  # i32[...]  most cloudlets in flight
    max_backlog: torch.Tensor     # i32[...]  most due, unadmitted arrivals
    energy_j: torch.Tensor        # f32[...]  total joules over real hosts
    transferred_mb: torch.Tensor  # f32[...]  MB moved by transfers


def summarize_stream(final: DatacenterState, st: StreamState
                     ) -> StreamSweepSummary:
    """Reduce streamed-lane results (any leading batch dims)."""
    stats = st.stats
    denom = torch.clamp(stats.n_retired.to(torch.float32), min=1.0)
    return StreamSweepSummary(
        n_retired=stats.n_retired, n_failed=stats.n_failed,
        makespan=stats.makespan,
        mean_response=stats.sum_response / denom, sum_len=stats.sum_len,
        peak_occupancy=st.peak_occupancy, max_backlog=st.max_backlog,
        energy_j=energy_total_j(final),
        transferred_mb=final.net_transferred_mb)


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------
class SweepSummary(NamedTuple):
    """Per-scenario scalars over the trailing entity axes.

    Leaf shape = the batch shape of the reduced state: [B] after
    ``run_batch``, [P, B] after ``run_grid``.
    """
    n_done: torch.Tensor          # i32[...]  completed cloudlets
    makespan: torch.Tensor        # f32[...]  latest completion, s (0: none)
    mean_response: torch.Tensor   # f32[...]  mean finish - submit over done
    total_cost: torch.Tensor      # f32[...]  market bill, $
    energy_j: torch.Tensor        # f32[...]  total joules over real hosts
    n_migrations: torch.Tensor    # i32[...]  live migrations performed
    mig_downtime: torch.Tensor    # f32[...]  summed migration delays, VM-s
    transferred_mb: torch.Tensor  # f32[...]  MB moved by transfers
    spot_cost: torch.Tensor       # f32[...]  accrued spot spend, $
    n_scale_up: torch.Tensor      # i32[...]  autoscaler VM creations
    n_scale_down: torch.Tensor    # i32[...]  autoscaler VM destructions


def summarize_batch(final: DatacenterState) -> SweepSummary:
    """Reduce a batched final state (any leading batch dims) to
    summaries."""
    cl = final.cloudlets
    done = cl.state == CL_DONE
    n_done = done.sum(dim=-1, dtype=torch.int32)
    resp = torch.where(done, cl.finish_time - cl.submit_time, 0.0)
    denom = torch.clamp(n_done.to(torch.float32), min=1.0)
    return SweepSummary(
        n_done=n_done,
        makespan=torch.where(done, cl.finish_time, 0.0).amax(dim=-1),
        mean_response=resp.sum(dim=-1) / denom,
        total_cost=final.acct.total,
        energy_j=energy_total_j(final),
        n_migrations=final.mig_count,
        mig_downtime=final.mig_downtime,
        transferred_mb=final.net_transferred_mb,
        spot_cost=final.scaler.spot_cost,
        n_scale_up=final.scaler.up_count,
        n_scale_down=final.scaler.down_count)
