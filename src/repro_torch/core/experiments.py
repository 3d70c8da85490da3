"""Federation-scale policy studies and closed-loop elasticity studies
(``repro.core.experiments`` in PyTorch).

An inter-cloud study (``run_study``): users shop VM fleets across
providers through the Cloud Information Service; the broker routes each
fleet to the cheapest feasible provider (``federation.assign_users``,
latency-aware or spot-reactive on request), and every (policy pair,
provider) cell then runs as one lane of a fused batch
(``sweep.run_grid``), reduced to federation-level metrics:

    fleets --(CIS register/query + FCFS routing)--> D datacenters
    D datacenters x P policy pairs --(sweep.run_grid)--> [P, D] results

Routing is set-up on the host (``build_study``); each cell equals the
single ``engine.run`` of its datacenter under its policy pair, bit for
bit.  A provider that wins no user keeps one never-provisioned VM slot
and one never-runnable cloudlet slot, whose lane commits nothing.

An elasticity study (``run_elasticity_study``) runs every (scenario,
autoscaler point) cell in one elastic batch (``sweep.run_policy_search``)
and the static baseline in another (``sweep.run_batch``); the reductions
are per-lane sums on the device and a NumPy Pareto mask on the host.
When the batch carries an enabled metrics plane, each point also gains
response percentiles (``telemetry.hist_percentile``) and its earliest
SLA breach.

Units follow the dense state: seconds, MI, MIPS, MB.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import broker as B
from repro_torch.core import cis, engine, sweep, telemetry
from repro_torch.core import federation as F
from repro_torch.core import state as S
from repro_torch.core.provisioning import FIRST_FIT
from repro_torch.device import resolve_device

__all__ = ["Provider", "UserFleet", "FederationStudy", "fleet_demand",
           "build_study", "run_study", "sla_violations", "pareto_front",
           "ElasticityStudy", "run_elasticity_study"]


@dataclasses.dataclass(frozen=True)
class Provider:
    """One federated datacenter offer: a host park and its market rates.
    ``events`` optionally attaches an event table (``state.make_events``,
    e.g. host outages) and ``net`` a topology (``state.make_topology``);
    None keeps the provider static and non-networked."""
    hosts: S.HostState
    rates: S.MarketRates
    events: object = None          # f32[E, 4] | None
    net: object = None             # state.NetTopology | None


@dataclasses.dataclass(frozen=True)
class UserFleet:
    """One user's request: VM classes to deploy, and the cloudlet waves
    every one of its VMs receives (``broker.WaveSpec``)."""
    vms: tuple[B.VmSpec, ...]
    waves: B.WaveSpec


class FederationStudy(NamedTuple):
    """``run_study``'s results: P policy pairs, D providers, U users."""
    table: cis.CisEntry          # CIS registry rows, leaves [D]
    assignment: torch.Tensor     # i32[U] provider per user (-1: rejected)
    final: S.DatacenterState     # final states, leaves [P, D, ...]
    summary: sweep.SweepSummary  # per-cell scalars, leaves [P, D]
    fed_makespan: torch.Tensor   # f32[P] latest completion in the federation
    fed_cost: torch.Tensor       # f32[P] market bills summed over providers
    fed_done: torch.Tensor       # i32[P] completed cloudlets
    fed_energy_j: torch.Tensor   # f32[P] host joules summed over providers
    fed_migrations: torch.Tensor  # i32[P] live migrations
    fed_transferred_mb: torch.Tensor  # f32[P] staged MB


def fleet_demand(fleets: Sequence[UserFleet], *, device=None
                 ) -> F.UserDemand:
    """Each fleet's totals the broker shops with: PEs, RAM and storage
    summed over its VMs, the MIPS floor the largest of its classes."""
    dev = resolve_device(device)
    col = lambda xs: torch.tensor(np.asarray(xs, np.float32), device=dev)
    return F.UserDemand(
        pes=col([float(sum(sp.count * sp.pes for sp in f.vms))
                 for f in fleets]),
        mips=col([float(max((sp.mips for sp in f.vms), default=0.0))
                  for f in fleets]),
        ram=col([float(sum(sp.count * sp.ram for sp in f.vms))
                 for f in fleets]),
        storage=col([float(sum(sp.count * sp.size for sp in f.vms))
                     for f in fleets]))


def _empty_vms(device) -> S.VmState:
    """One never-provisioned VM slot (keeps the VM axis non-empty)."""
    vms = S.make_vms([0], 0.0, 0.0, 0.0, 0.0, device=device)
    return dataclasses.replace(vms, state=torch.full_like(vms.state,
                                                          S.VM_EMPTY))


def _empty_cloudlets(device) -> S.CloudletState:
    """One never-runnable cloudlet slot, of no VM."""
    cl = S.make_cloudlets([-1], 0.0, device=device)
    return dataclasses.replace(cl, state=torch.full_like(cl.state,
                                                         S.CL_EMPTY))


def _concat_blocks(blocks):
    """Entity blocks of one type, concatenated field by field."""
    if len(blocks) == 1:
        return blocks[0]
    return S.with_leaves(blocks[0], [
        torch.cat(xs) for xs in zip(*(S.tensor_leaves(b) for b in blocks))])


def build_study(providers: Sequence[Provider],
                fleets: Sequence[UserFleet], *,
                vm_policy: int = S.SPACE_SHARED,
                task_policy: int = S.SPACE_SHARED,
                reserve_pes: bool = True,
                mig_policy: int = S.MIG_OFF,
                mig_threshold: float = 0.8,
                mig_energy_per_mb: float = 0.0,
                latency=None, origin=None,
                latency_weight: float = 0.0,
                spot=None, spot_horizon: float = 0.0, device=None
                ) -> tuple[list[S.DatacenterState], torch.Tensor,
                           cis.CisEntry]:
    """Route fleets across providers; build one datacenter each.

    Returns ``(dcs, assignment, table)``: D single-scenario states with
    the routed fleets deployed (ready for ``sweep.stack_scenarios``),
    the i32[U] user -> provider assignment (-1: no feasible provider),
    and the registry table the broker used (leaves [D]).  Every provider
    registers, ``federation.assign_users`` grants each user in turn the
    cheapest feasible provider (``latency``/``origin``/
    ``latency_weight`` weigh WAN distance; ``spot`` and
    ``spot_horizon`` add each provider's forecast spot price,
    ``federation.cloudburst_assign``), and each granted fleet's VMs and
    cloudlet waves are appended to its provider's blocks.
    """
    dev = resolve_device(device)
    bare = [S.make_datacenter(p.hosts, _empty_vms(dev), _empty_cloudlets(dev),
                              vm_policy=vm_policy, task_policy=task_policy,
                              reserve_pes=reserve_pes, rates=p.rates,
                              events=p.events, mig_policy=mig_policy,
                              mig_threshold=mig_threshold,
                              mig_energy_per_mb=mig_energy_per_mb,
                              net=p.net, device=dev)
            for p in providers]
    table = cis.stack([cis.register(d) for d in bare])
    demand = fleet_demand(fleets, device=dev)
    route = dict(latency=latency, origin=origin,
                 latency_weight=latency_weight)
    if spot is not None:
        assignment = F.cloudburst_assign(table, demand, spot,
                                         horizon=spot_horizon, **route)
    else:
        assignment = F.assign_users(table, demand, **route)
    assign_np = assignment.cpu().numpy()

    dcs = []
    for d, dc0 in enumerate(bare):
        vm_blocks, cl_blocks, vm_off = [], [], 0
        for u, fleet in enumerate(fleets):
            if int(assign_np[u]) != d:
                continue
            vms_u = B.build_fleet(list(fleet.vms), device=dev)
            n_vms_u = vms_u.req_pes.shape[0]
            cl_u = B.build_waves(n_vms_u, fleet.waves, device=dev)
            vm_blocks.append(vms_u)
            cl_blocks.append(dataclasses.replace(cl_u, vm=cl_u.vm + vm_off))
            vm_off += n_vms_u
        if not vm_blocks:               # the provider won no user
            vm_blocks, cl_blocks = [_empty_vms(dev)], [_empty_cloudlets(dev)]
        dcs.append(dataclasses.replace(
            dc0, vms=_concat_blocks(vm_blocks),
            cloudlets=_concat_blocks(cl_blocks)))
    return dcs, assignment, table


def run_study(providers: Sequence[Provider], fleets: Sequence[UserFleet],
              vm_policies, task_policies, *, max_steps: int = 100_000,
              provision_policy: int = FIRST_FIT, reserve_pes: bool = True,
              mig_policy: int = S.MIG_OFF, mig_threshold: float = 0.8,
              mig_energy_per_mb: float = 0.0,
              latency=None, origin=None, latency_weight: float = 0.0,
              spot=None, spot_horizon: float = 0.0,
              devices=None, sharded: bool | None = None,
              device=None) -> FederationStudy:
    """An inter-cloud policy study, end to end: ``build_study`` routes
    the fleets once; the D datacenters under all P ``(vm_policies[i],
    task_policies[i])`` pairs run as one fused batch of P*D lanes
    (``sweep.run_grid``; ``devices``/``sharded`` forward to it), reduced
    to federation metrics over the providers."""
    dcs, assignment, table = build_study(
        providers, fleets, reserve_pes=reserve_pes, mig_policy=mig_policy,
        mig_threshold=mig_threshold, mig_energy_per_mb=mig_energy_per_mb,
        latency=latency, origin=origin, latency_weight=latency_weight,
        spot=spot, spot_horizon=spot_horizon, device=device)
    final = sweep.run_grid(sweep.stack_scenarios(dcs), vm_policies,
                           task_policies, max_steps=max_steps,
                           provision_policy=provision_policy,
                           devices=devices, sharded=sharded)
    summary = sweep.summarize_batch(final)      # leaves [P, D]
    return FederationStudy(
        table=table, assignment=assignment, final=final, summary=summary,
        fed_makespan=summary.makespan.amax(dim=-1),
        fed_cost=summary.total_cost.sum(dim=-1),
        fed_done=summary.n_done.sum(dim=-1, dtype=torch.int32),
        fed_energy_j=summary.energy_j.sum(dim=-1),
        fed_migrations=summary.n_migrations.sum(dim=-1, dtype=torch.int32),
        fed_transferred_mb=summary.transferred_mb.sum(dim=-1))


def sla_violations(final: S.DatacenterState, *, factor: float = 2.0,
                   include_unfinished: bool = False) -> torch.Tensor:
    """i32[...] — completed cloudlets whose response exceeded ``factor``
    times their dedicated service time (``length / req_mips`` of their
    VM), over the trailing cloudlet axis.  ``include_unfinished`` also
    counts cloudlets still ``CL_CREATED`` (work stranded on slots the
    autoscaler never brought up)."""
    cl, vms = final.cloudlets, final.vms
    nv = vms.req_mips.shape[-1]
    owner = torch.clamp(cl.vm, 0, nv - 1).long()
    mips = torch.gather(vms.req_mips, -1, owner)
    ideal = cl.length / torch.clamp(mips, min=1e-30)
    done = cl.state == S.CL_DONE
    resp = cl.finish_time - cl.submit_time
    viol = done & (resp > float(np.float32(factor)) * ideal)
    if include_unfinished:
        viol = viol | (cl.state == S.CL_CREATED)
    return viol.sum(dim=-1, dtype=torch.int32)


def pareto_front(points) -> np.ndarray:
    """bool[N] — nondominated rows of an [N, K] objective table, every
    objective minimised: a row is dominated when another row is <=
    everywhere and < somewhere; duplicates of a front point stay on it."""
    pts = np.asarray(points, np.float64)
    if pts.ndim != 2:
        raise ValueError(f"expected [N, K] objectives, got {pts.shape}")
    n = pts.shape[0]
    mask = np.ones(n, bool)
    for i in range(n):
        dominated = (np.all(pts <= pts[i], axis=1)
                     & np.any(pts < pts[i], axis=1))
        if dominated.any():
            mask[i] = False
    return mask


class ElasticityStudy(NamedTuple):
    """``run_elasticity_study``'s results: P policy points, B scenarios.
    ``cost`` is spot spend plus the market bill over the scenarios;
    ``pareto`` marks the nondominated (cost, SLA violations, energy)
    points.  The latency and breach columns are NaN when probes are
    off."""
    grid: sweep.PolicyGrid
    final: S.DatacenterState      # final states, leaves [P, B, ...]
    summary: sweep.SweepSummary   # per-cell scalars, leaves [P, B]
    sla: torch.Tensor             # i32[P] SLA violations over scenarios
    cost: torch.Tensor            # f32[P] spot + market $ over scenarios
    energy_j: torch.Tensor        # f32[P] joules over scenarios
    pareto: np.ndarray            # bool[P] nondominated points
    static_summary: sweep.SweepSummary  # static baseline, leaves [B]
    static_sla: torch.Tensor      # i32[] baseline SLA violations
    static_cost: torch.Tensor     # f32[] baseline spot + market $
    static_energy_j: torch.Tensor  # f32[] baseline joules
    latency_p50: np.ndarray       # f64[P] response p50 over scenarios
    latency_p95: np.ndarray       # f64[P] response p95
    first_breach_t: np.ndarray    # f64[P] earliest SLA breach (NaN: none)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def run_elasticity_study(batch: S.DatacenterState, grid: sweep.PolicyGrid,
                         *, static_batch: S.DatacenterState | None = None,
                         sla_factor: float = 2.0,
                         include_unfinished: bool = True,
                         max_steps: int = 1_000_000,
                         provision_policy: int = FIRST_FIT,
                         devices=None, partitioner: str = "auto"
                         ) -> ElasticityStudy:
    """Policy search, then the Pareto front against a static fleet.

    Every (scenario, point) cell runs in one elastic batch; the baseline
    is ``static_batch`` (default: ``batch`` with the scaler disabled and
    its spot accrual live, so a static fleet pays the spot price for
    every alive VM all run long).  ``devices`` and ``partitioner``
    forward to ``sweep.run_policy_search``."""
    final = sweep.run_policy_search(batch, grid, max_steps=max_steps,
                                    provision_policy=provision_policy,
                                    devices=devices, partitioner=partitioner)
    summary = sweep.summarize_batch(final)
    sla = sla_violations(final, factor=sla_factor,
                         include_unfinished=include_unfinished).sum(
        dim=-1, dtype=torch.int32)
    cost = (summary.total_cost + summary.spot_cost).sum(dim=-1)
    energy = summary.energy_j.sum(dim=-1)
    front = pareto_front(np.stack([_np(cost).astype(np.float64),
                                   _np(sla).astype(np.float64),
                                   _np(energy).astype(np.float64)], axis=1))
    n_pol = int(cost.shape[0])
    if engine.wants_probes(batch):
        m = final.metrics
        hist = _np(m.hist_response).astype(np.int64)        # [P, B, NB]
        edges = _np(m.edges).reshape(hist.shape[:2] + (-1,))[0, 0]
        lat50 = np.array([telemetry.hist_percentile(hist[p].sum(0), edges,
                                                    50)
                          for p in range(n_pol)])
        lat95 = np.array([telemetry.hist_percentile(hist[p].sum(0), edges,
                                                    95)
                          for p in range(n_pol)])
        fb = _np(m.first_breach_t).astype(np.float64).min(axis=-1)
        breach_t = np.where(fb >= telemetry._METRICS_INF, np.nan, fb)
    else:
        lat50 = np.full(n_pol, np.nan)
        lat95 = np.full(n_pol, np.nan)
        breach_t = np.full(n_pol, np.nan)
    if static_batch is None:
        static_batch = dataclasses.replace(
            batch, scaler=dataclasses.replace(
                batch.scaler,
                enabled=torch.zeros_like(batch.scaler.enabled)))
    sfinal = sweep.run_batch(static_batch, max_steps=max_steps,
                             provision_policy=provision_policy)
    ssum = sweep.summarize_batch(sfinal)
    return ElasticityStudy(
        grid=grid, final=final, summary=summary,
        sla=sla, cost=cost, energy_j=energy, pareto=front,
        static_summary=ssum,
        static_sla=sla_violations(
            sfinal, factor=sla_factor,
            include_unfinished=include_unfinished).sum(dtype=torch.int32),
        static_cost=(ssum.total_cost + ssum.spot_cost).sum(),
        static_energy_j=ssum.energy_j.sum(),
        latency_p50=lat50,
        latency_p95=lat95,
        first_breach_t=breach_t,
    )
