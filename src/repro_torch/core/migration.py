"""Live VM migration (``repro.core.migration`` in PyTorch): trigger
policies, the delay model and joule accounting.

One migration per simulation event; a same-instant cascade chains
through zero-dt events (``engine``).  The trigger policies
(``DatacenterState.mig_policy``, one per lane):

  * ``MIG_THRESHOLD`` — offload: if a valid host's CPU utilization
    exceeds ``mig_threshold``, the most loaded such host migrates one VM
    to the emptiest feasible host (WORST_FIT) whose *projected*
    utilization — resident VM demand plus the victim's, over capacity —
    stays within the threshold.
  * ``MIG_DRAIN`` — consolidation: among loaded hosts below the
    threshold, the least RAM-utilized one moves one VM onto the fullest
    feasible host (MOST_FULL) that is strictly more RAM-utilized than
    the source and whose projected utilization stays <= 1.

The victim is the migratable VM with the least RAM (ties to the lowest
slot).  The copy takes ``ram / (0.5 * min(bw_src, bw_dst))`` seconds, or
under an enabled topology the routed ``lat + ram / bw`` of the source ->
target link (``network.lane_route``).  During the copy the VM's
resources already sit on the destination and its cloudlets run at rate
0; ``mig_energy_per_mb * ram`` joules are charged half to each host.

Every pass works on a batch of lanes, a decision per lane; the
functions under the JAX package's names take one state.  The per-host
sums of resident demand run in a fixed order (``scheduling.host_sums``),
and utilization comes from the f64 per-host sum
(``scheduling.host_consumed``), so a decision is the same on the card
and on the CPU, alone or in a batch.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import energy, network, scheduling
from repro_torch.core.provisioning import (MOST_FULL, WORST_FIT, _pick,
                                           feasible_hosts)
from repro_torch.core.scheduling import HostPlan, Lanes
from repro_torch.core.state import (MIG_DRAIN, MIG_OFF, MIG_THRESHOLD,
                                    VM_ACTIVE, DatacenterState, map_tensors)

__all__ = ["MIG_OFF", "MIG_THRESHOLD", "MIG_DRAIN", "migration_delay",
           "Migration", "select_migration", "apply_selected",
           "apply_migration", "lane_select", "lane_apply"]

_BIG = 1e30


def migration_delay(ram, bw_src, bw_dst):
    """f32 seconds to copy ``ram`` MB over the slower link at half rate."""
    link = 0.5 * torch.minimum(torch.as_tensor(bw_src),
                               torch.as_tensor(bw_dst))
    return ram / torch.clamp(link, min=1e-30)


class Migration(NamedTuple):
    """One migration decision per lane ([B] leaves; 0-d for one state)."""
    trigger: torch.Tensor   # bool  a migration fires this event
    vm: torch.Tensor        # i32   victim VM slot
    src: torch.Tensor       # i32   source host
    dst: torch.Tensor       # i32   destination host (-1 if none)
    delay: torch.Tensor     # f32   copy seconds (downtime window)


def _at(field: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B] ``field[b, idx[b]]`` of a [B, N] field."""
    return field.gather(1, idx.long()[:, None])[:, 0]


def lane_select(dc: DatacenterState, rates: torch.Tensor, lanes: Lanes,
                plan: HostPlan, *, networked: bool = False) -> Migration:
    """Each lane's trigger policy on its state and cloudlet ``rates``
    ([B, C]); a pure decision, no state change.  ``plan`` is the host
    plan of ``dc``.  ``networked`` switches the copy delay of enabled
    lanes to the topology route."""
    hosts, vms = dc.hosts, dc.vms
    b, h = lanes.n_lanes, lanes.n_hosts
    util = energy.utilization_of(hosts, scheduling.host_consumed(
        rates.reshape(-1), lanes, plan))
    occupancy = plan.occupancy.view(b, h)
    thr = dc.mig_threshold[:, None]

    # ---- source host ------------------------------------------------------
    loaded = hosts.valid & (occupancy > 0)
    over = loaded & (util > thr)
    src_thr = torch.argmax(torch.where(over, util, -_BIG), dim=-1)
    under = loaded & (util < thr)
    frac = 1.0 - hosts.free_ram / torch.clamp(hosts.ram, min=1e-30)
    src_drn = torch.argmin(torch.where(under, frac, _BIG), dim=-1)
    is_thr = dc.mig_policy == MIG_THRESHOLD
    src = torch.where(is_thr, src_thr, src_drn)
    trigger = ((dc.mig_policy != MIG_OFF)
               & torch.where(is_thr, over.any(dim=-1), under.any(dim=-1)))

    # ---- victim: minimum migration time (least RAM, lowest slot) ----------
    placed = (vms.state == VM_ACTIVE) & (vms.host >= 0)
    migratable = (placed & (vms.host == src[:, None])
                  & (vms.mig_remaining <= 0.0))
    v = torch.argmin(torch.where(migratable, vms.ram, _BIG), dim=-1)
    trigger &= migratable.any(dim=-1)

    # ---- destination: feasible, not the source, under the guard ----------
    vm = lambda field: _at(field, v)[:, None]
    feas = feasible_hosts(
        dc, hosts.free_ram, hosts.free_bw, hosts.free_storage,
        hosts.free_pes, ram=vm(vms.ram), bw=vm(vms.bw), size=vm(vms.size),
        req_pes=vm(vms.req_pes), req_mips=vm(vms.req_mips))
    feas &= torch.arange(h, device=src.device) != src[:, None]
    # projected utilization once the victim resumes there, from resident
    # VM demand (placement-based, mid-copy VMs included), so a target
    # never silently oversubscribes
    resident = scheduling.host_sums(torch.where(
        placed.reshape(-1), plan.demand, 0.0), plan, b * h).view(b, h)
    demand = (vm(vms.req_pes).to(torch.float32)
              * torch.minimum(vm(vms.req_mips), hosts.mips_per_pe))
    proj = (resident + demand) / torch.clamp(hosts.capacity_mips,
                                             min=1e-30)
    feas &= torch.where(is_thr[:, None], proj <= thr,
                        (frac > _at(frac, src)[:, None]) & (proj <= 1.0))
    # provisioning's choice, a policy per lane: WORST_FIT for THRESHOLD,
    # MOST_FULL for DRAIN
    pick = lambda policy: _pick(feas, hosts.free_ram, hosts.ram, policy,
                                None, None)
    dst = torch.where(feas.any(dim=-1),
                      torch.where(is_thr, pick(WORST_FIT), pick(MOST_FULL)),
                      -1)
    trigger &= dst >= 0

    dstc = torch.clamp(dst, min=0)
    ram = vm(vms.ram)[:, 0]
    delay = migration_delay(ram, _at(hosts.bw, src), _at(hosts.bw, dstc))
    if networked:
        link_bw, link_lat = network.lane_route(dc, src, dstc)
        net_delay = link_lat + ram / torch.clamp(link_bw, min=1e-30)
        delay = torch.where(dc.net.enabled == 1, net_delay, delay)
    i32 = lambda t: t.to(torch.int32)
    return Migration(trigger=trigger, vm=i32(v), src=i32(src), dst=i32(dst),
                     delay=delay)


def lane_apply(dc: DatacenterState, mig: Migration) -> DatacenterState:
    """Apply each lane's decision ``mig`` ([B] leaves).

    Moves the victim's RAM, BW and storage (and its PEs under
    ``reserve_pes``) from the source's pools to the destination's,
    repoints ``vms.host``, starts the downtime clock and books the copy
    joules and the stats.  A lane whose ``trigger`` is False gets zeros
    added, a bit-exact identity."""
    hosts, vms = dc.hosts, dc.vms
    h = hosts.num_pes.shape[-1]
    trig = mig.trigger
    v = mig.vm.long()[:, None]
    src = mig.src.long()[:, None]
    dst = torch.clamp(mig.dst.long(), 0, h - 1)[:, None]
    at_v = lambda field: field.gather(1, v)
    amt = lambda x: torch.where(trig[:, None], x, 0.0)

    def move(pool, x):
        return (pool.scatter_add(1, src, amt(x))
                .scatter_add(1, dst, -amt(x)))

    reserve = torch.where(dc.reserve_pes[:, None] == 1,
                          at_v(vms.req_pes).to(torch.float32), 0.0)
    joules = amt(0.5 * at_v(vms.ram) * dc.mig_energy_per_mb[:, None])
    new_hosts = dataclasses.replace(
        hosts,
        free_ram=move(hosts.free_ram, at_v(vms.ram)),
        free_bw=move(hosts.free_bw, at_v(vms.bw)),
        free_storage=move(hosts.free_storage, at_v(vms.size)),
        free_pes=move(hosts.free_pes, reserve),
        energy_j=(hosts.energy_j.scatter_add(1, src, joules)
                  .scatter_add(1, dst, joules)))
    host_v = torch.where(trig[:, None], mig.dst[:, None], at_v(vms.host))
    mig_v = torch.where(trig[:, None], mig.delay[:, None],
                        at_v(vms.mig_remaining))
    new_vms = dataclasses.replace(
        vms, host=vms.host.scatter(1, v, host_v.to(vms.host.dtype)),
        mig_remaining=vms.mig_remaining.scatter(1, v, mig_v))
    return dataclasses.replace(
        dc, hosts=new_hosts, vms=new_vms,
        mig_count=dc.mig_count + trig.to(torch.int32),
        mig_downtime=dc.mig_downtime + amt(mig.delay[:, None])[:, 0])


# ---------------------------------------------------------------------------
# One state (a batch of one lane), under the JAX package's names
# ---------------------------------------------------------------------------
def select_migration(dc: DatacenterState, rates: torch.Tensor, *,
                     networked: bool = False) -> Migration:
    """The trigger policy on one state and its cloudlet ``rates`` ([C])."""
    batch = scheduling.lane_axis(dc)
    lanes = scheduling.lanes_of(batch)
    plan = scheduling.host_plan(batch, lanes)
    mig = lane_select(batch, rates[None], lanes, plan, networked=networked)
    return Migration(*(t[0] for t in mig))


def apply_selected(dc: DatacenterState, mig: Migration) -> DatacenterState:
    """Apply one precomputed decision (a bit-exact identity when it does
    not trigger)."""
    batch = scheduling.lane_axis(dc)
    out = lane_apply(batch, Migration(*(torch.as_tensor(
        t, device=dc.time.device).reshape(1) for t in mig)))
    return map_tensors(lambda t: t[0], out)


def apply_migration(dc: DatacenterState, rates: torch.Tensor, *,
                    networked: bool = False
                    ) -> tuple[DatacenterState, Migration]:
    """Select and apply at most one migration for this event."""
    mig = select_migration(dc, rates, networked=networked)
    return apply_selected(dc, mig), mig
