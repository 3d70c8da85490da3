"""Federated multi-datacenter simulation (``repro.core.federation`` in
PyTorch): the paper's stated future work, a federated network of clouds.

Each datacenter registers a CIS row (``cis.register``); a broker routes
every user's fleet to the cheapest feasible datacenter
(``assign_users``, optionally weighing WAN latency or forecast spot
prices, ``cloudburst_assign``); then the datacenters run independently.
``vmap_federation`` runs the D datacenters as lanes of one batch
(``engine.batched_run``); ``federated_run`` runs datacenter d on
``devices[d % len(devices)]``, one run each, and stacks the registry
rows, or, given a live ``launch.mesh.Mesh`` (JAX's form), runs
datacenter d on rank d of its ``axis`` and all-gathers the registry
rows, the final states and the reports over it, so every rank holds
the whole federation.  Lane d of a batch equals the single run of
datacenter d, so all of them agree bit for bit.

The routing greedy is sequential over users: experiment set-up over a
table with one row a datacenter.  It runs on the host in NumPy f32,
with the JAX scan's arithmetic and tie rule, and returns its answer on
the table's device.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import broker, cis, engine, market
from repro_torch.core import state as S
from repro_torch.core.provisioning import FIRST_FIT
from repro_torch.core.sweep import gather_lanes
from repro_torch.device import resolve_device

__all__ = ["UserDemand", "assign_users", "cloudburst_assign",
           "federated_run", "vmap_federation"]


class UserDemand(NamedTuple):
    """Each user's aggregate fleet requirements (U users;
    ``experiments.fleet_demand`` builds it)."""
    pes: torch.Tensor        # f32[U] total PEs wanted
    mips: torch.Tensor       # f32[U] per-PE MIPS floor
    ram: torch.Tensor        # f32[U] total RAM (MB)
    storage: torch.Tensor    # f32[U] total storage (MB)


def _host(x, dtype=np.float32) -> np.ndarray:
    """A tensor or sequence as a NumPy copy on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype)


def assign_users(table: cis.CisEntry, demand: UserDemand, *,
                 latency=None, origin=None,
                 latency_weight: float = 0.0) -> torch.Tensor:
    """i32[U] — the cheapest feasible datacenter for each user in turn,
    capacity-aware (earlier users consume the PEs, RAM and storage that
    later ones see); -1 for a user no datacenter can host.

    Latency-aware routing: ``latency`` is an f32[D, D] inter-datacenter
    latency matrix (s), ``origin`` each user's home row (default 0), and
    user ``u`` goes to the feasible datacenter minimising
    ``cost_per_cpu_sec[d] + latency_weight * latency[origin[u], d]``.
    ``latency=None`` is latency-blind routing.  Equal scores go to the
    first row.
    """
    pes, mips = _host(demand.pes), _host(demand.mips)
    ram, sto = _host(demand.ram), _host(demand.storage)
    n_users = pes.shape[0]
    free_pes, free_ram = _host(table.free_pes), _host(table.free_ram)
    free_sto = _host(table.free_storage)
    max_mips, price = _host(table.max_mips_pe), _host(table.cost_per_cpu_sec)
    if latency is not None:
        latency = _host(latency)
        nd = latency.shape[0]
        origin = (np.zeros(n_users, np.int64) if origin is None
                  else _host(origin, np.int64).reshape(n_users))
        weight = np.float32(latency_weight)
    big = np.float32(1e30)
    out = np.full(n_users, -1, np.int32)
    for u in range(n_users):
        feas = ((free_pes >= pes[u]) & (max_mips >= mips[u])
                & (free_ram >= ram[u]) & (free_sto >= sto[u]))
        score = price
        if latency is not None:
            score = price + weight * latency[min(max(origin[u], 0), nd - 1)]
        if not feas.any():
            continue
        pick = int(np.argmin(np.where(feas, score, big)))
        out[u] = pick
        free_pes[pick] = free_pes[pick] - pes[u]
        free_ram[pick] = free_ram[pick] - ram[u]
        free_sto[pick] = free_sto[pick] - sto[u]
    return torch.from_numpy(out).to(table.free_pes.device)


def cloudburst_assign(table: cis.CisEntry, demand: UserDemand,
                      spot: market.SpotMarket, *, horizon: float,
                      latency=None, origin=None,
                      latency_weight: float = 0.0) -> torch.Tensor:
    """Spot-reactive cloudbursting: each provider's routing score gains
    its time-averaged spot price over ``[0, horizon]``
    (``market.mean_spot_price``), so burst fleets go to the cheapest
    forecast provider with capacity.  ``spot``'s rows align with the
    table's."""
    bias = market.mean_spot_price(spot, horizon=horizon)
    biased = table._replace(
        cost_per_cpu_sec=table.cost_per_cpu_sec + bias.to(
            table.cost_per_cpu_sec.device))
    return assign_users(biased, demand, latency=latency, origin=origin,
                        latency_weight=latency_weight)


def _lane(batch, d: int):
    return S.map_tensors(lambda t: t[d], batch)


def _rows_to(row, device):
    """A registry row or a report (a tuple of tensors) on ``device``."""
    return type(row)(*(t.to(device) for t in row))


def _stack_reports(reps: Sequence[broker.BrokerReport]
                   ) -> broker.BrokerReport:
    return broker.BrokerReport(*(torch.stack(col) for col in zip(*reps)))


def vmap_federation(dc_stack: S.DatacenterState, *,
                    max_steps: int = 100_000,
                    provision_policy: int = FIRST_FIT):
    """D datacenters as the lanes of one batch: ``(final stacked state
    [D, ...], stacked BrokerReport [D], CIS table [D])``; the table
    describes the initial states (capacity before any placement)."""
    out = engine.batched_run(dc_stack, max_steps=max_steps,
                             provision_policy=provision_policy)
    n_dc = dc_stack.time.shape[0]
    rep = _stack_reports([broker.collect(_lane(out, d))
                          for d in range(n_dc)])
    table = cis.stack([cis.register(_lane(dc_stack, d))
                       for d in range(n_dc)])
    return out, rep, table


def _federated_on_mesh(dc_stack, mesh, axis: str, max_steps: int,
                       provision_policy: int):
    """Datacenter d on rank d of ``axis``: its registry row, final state
    and report, all-gathered over ``axis``."""
    n_dc, n = dc_stack.time.shape[0], mesh.axis_size(axis)
    if n_dc != n:
        raise ValueError(f"{n_dc} datacenters on an axis {axis!r} of {n} "
                         f"ranks: one datacenter a rank")
    dc = S.to_device(_lane(dc_stack, mesh.axis_index(axis)), mesh.device)
    gather = lambda row: type(row)(*(  # noqa: E731
        gather_lanes(t[None], mesh, axis) for t in row))
    table = gather(cis.register(dc))
    out = engine.run(dc, max_steps=max_steps,
                     provision_policy=provision_policy)
    rep = gather(broker.collect(out))
    out = gather_lanes(S.map_tensors(lambda t: t[None], out), mesh, axis)
    return out, rep, table


def federated_run(dc_stack: S.DatacenterState, *,
                  devices: Sequence | None = None, mesh=None,
                  axis: str = "dc", max_steps: int = 100_000,
                  provision_policy: int = FIRST_FIT):
    """Datacenter d of ``dc_stack`` (leaves [D, ...]) runs alone on
    ``devices[d % len(devices)]`` (default: the card); the results and
    registry rows are stacked on ``devices[0]``, in the layout of
    ``vmap_federation``, which they equal bit for bit.

    With ``mesh`` (a live ``launch.mesh.Mesh`` whose ``axis`` has D
    ranks, JAX's ``federated_run(mesh, ...)``): datacenter d runs on rank
    d of ``axis``; every rank returns the whole triple (final states
    [D], reports [D], the table of the initial states [D]) on its own
    device."""
    if mesh is not None:
        if devices is not None:
            raise ValueError("federated_run takes devices or a mesh, not "
                             "both")
        return _federated_on_mesh(dc_stack, mesh, axis, max_steps,
                                  provision_policy)
    devs = ([resolve_device()] if devices is None
            else [resolve_device(d) for d in devices])
    home = devs[0]
    n_dc = dc_stack.time.shape[0]
    outs, reps, rows = [], [], []
    for d in range(n_dc):
        dc = S.to_device(_lane(dc_stack, d), devs[d % len(devs)])
        rows.append(_rows_to(cis.register(dc), home))
        out = engine.run(dc, max_steps=max_steps,
                         provision_policy=provision_policy)
        reps.append(_rows_to(broker.collect(out), home))
        outs.append(S.to_device(out, home))
    out = S.with_leaves(outs[0], [torch.stack(col) for col in zip(
        *(S.tensor_leaves(o) for o in outs))])
    return out, _stack_reports(reps), cis.stack(rows)
