"""Topology-aware network model (``repro.core.network`` in PyTorch):
staged transfers as fluid fair-shared flows.

Hosts group into edge clusters (``NetTopology.cluster``) under three
nested link tiers: the datacenter's WAN gateway, each cluster's uplink,
and each host's access fabric.  Under an enabled topology a cloudlet's
data moves before and after execution: NET_PRE -> NET_STAGE_IN
(``file_size`` MB in) -> NET_RUN -> NET_STAGE_OUT (``output_size`` MB
out) -> CL_DONE.  Each transfer serializes a latency countdown
(``lat_wan + lat_inter + lat_intra``) and then a bandwidth phase at the
bottleneck fair share of its path::

    rate(c) = min( bw_wan   / n_flows(lane),
                   bw_inter / n_flows(cluster of host(c)),
                   bw_intra / n_flows(host(c)) )

Rates are piecewise constant between events, so transfer completions
join the event queue as deltas, like cloudlet completions.  Migration
copies route over the source -> target link: same cluster -> ``lat_intra
+ ram / bw_intra``, across clusters -> ``lat_inter + ram / bw_inter``.

Every pass here works on a batch of lanes (leading lane axis, the flat
axes of ``scheduling.Lanes``); the functions under the JAX package's
names take one state.  Flow counts are integers; the per-host joules of
drained transfers and each lane's moved MB are summed in a fixed order
(``scheduling.vm_sums`` then ``host_sums``, ``segments.pairwise_sum``),
so a lane gives the same bits alone or in a batch.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import scheduling
from repro_torch.spans import span
from repro_torch.core.scheduling import HostPlan, Lanes, lane_min
from repro_torch.core.segments import pairwise_sum
from repro_torch.core.state import (CL_CREATED, CL_DONE, INF, NET_PRE,
                                    NET_RUN, NET_STAGE_IN, NET_STAGE_OUT,
                                    VM_ACTIVE, DatacenterState, map_tensors)

__all__ = ["wants_network", "stage_latency", "staging_mask", "flow_rates",
           "wake_deltas", "advance_phases", "transfer_accounting",
           "migration_route", "lane_staging", "lane_flow_rates",
           "lane_wake_deltas", "lane_advance_phases",
           "lane_transfer_accounting"]


def wants_network(dc: DatacenterState) -> bool:
    """True when the scenario (or some lane of a batch) carries an
    enabled topology."""
    with span("sync.passes.network"):
        return bool((dc.net.enabled != 0).any())


def stage_latency(dc: DatacenterState) -> torch.Tensor:
    """f32[] (f32[B] on a batch) — seconds of serial path latency a
    staged transfer waits: it crosses all three tiers."""
    net = dc.net
    return net.lat_wan + net.lat_inter + net.lat_intra


def _owner_field(field: torch.Tensor, lanes: Lanes) -> torch.Tensor:
    """[B, C] a per-VM field ([B, V]) read at each slot's VM."""
    return field.reshape(-1)[lanes.slot_vm].view(lanes.n_lanes,
                                                 lanes.n_cloudlets)


def lane_staging(dc: DatacenterState, lanes: Lanes) -> torch.Tensor:
    """bool[B, C] — cloudlets with an in-flight staged transfer.

    The route needs a live placement: a transfer whose VM is evicted back
    to PENDING pauses with its counters kept and resumes once the VM is
    placed again.  A VM mid-migration keeps transferring (its host
    already points at the destination)."""
    cl, vms = dc.cloudlets, dc.vms
    vm_live = ((_owner_field(vms.state, lanes) == VM_ACTIVE)
               & (_owner_field(vms.host, lanes) >= 0) & (cl.vm >= 0))
    in_stage = ((cl.net_phase == NET_STAGE_IN)
                | (cl.net_phase == NET_STAGE_OUT))
    return ((dc.net.enabled[:, None] == 1) & (cl.state == CL_CREATED)
            & vm_live & in_stage)


def _slot_host(dc: DatacenterState, lanes: Lanes) -> torch.Tensor:
    """i64[B, C] each slot's VM's host within its lane, clamped."""
    host = _owner_field(dc.vms.host, lanes).long()
    return torch.clamp(host, 0, max(lanes.n_hosts - 1, 0))


def lane_flow_rates(dc: DatacenterState, lanes: Lanes) -> torch.Tensor:
    """f32[B, C] — MB/s granted to each active transfer this event: the
    bottleneck fair share over its three-tier path, zero for cloudlets
    without an active flow."""
    cl, net = dc.cloudlets, dc.net
    b, h = lanes.n_lanes, lanes.n_hosts
    flow = (lane_staging(dc, lanes) & (cl.net_lat <= 0.0)
            & (cl.net_remaining > 0.0))
    host = _slot_host(dc, lanes)
    k = torch.clamp(net.cluster.gather(1, host).long(), 0, max(h - 1, 0))
    base = torch.arange(b, device=host.device)[:, None] * h
    ones = flow.to(torch.int32).reshape(-1)

    def per(group):         # flows sharing each slot's group, as integers
        g = (group + base).reshape(-1)
        n = torch.zeros((b * h,), dtype=torch.int32,
                        device=host.device).index_add_(0, g, ones)
        return n[g].view(b, -1).to(torch.float32)

    n_wan = flow.sum(dim=-1, dtype=torch.int32).to(torch.float32)
    share = torch.minimum(
        net.bw_wan[:, None] / torch.clamp(n_wan, min=1.0)[:, None],
        torch.minimum(net.bw_inter[:, None] / torch.clamp(per(k), min=1.0),
                      net.bw_intra[:, None]
                      / torch.clamp(per(host), min=1.0)))
    return torch.where(flow, share, 0.0)


def lane_wake_deltas(dc: DatacenterState, frates: torch.Tensor,
                     lanes: Lanes) -> tuple[torch.Tensor, torch.Tensor]:
    """(dt_net f32[B], flow_dt f32[B, C]) — the network's event-queue
    head: each flow's remaining MB / rate (INF when idle), and per lane
    the earliest of those and of the latency countdowns."""
    cl = dc.cloudlets
    lat_active = lane_staging(dc, lanes) & (cl.net_lat > 0.0)
    dt_lat = lane_min(torch.where(lat_active, cl.net_lat, INF))
    flow_dt = torch.where(frates > 0.0, cl.net_remaining
                          / torch.clamp(frates, min=1e-30), INF)
    return torch.minimum(dt_lat, lane_min(flow_dt)), flow_dt


def lane_advance_phases(dc: DatacenterState, lanes: Lanes
                        ) -> DatacenterState:
    """Every staging-phase transition due at ``dc.time``, on every lane.

      1. NET_PRE -> NET_STAGE_IN: the input transfer is armed the instant
         the cloudlet could otherwise run (submitted, VM placed and not
         migrating).
      2. NET_STAGE_IN -> NET_RUN once latency and payload are spent (in
         the same call as 1, so an empty transfer costs no event).
      3. NET_STAGE_OUT -> CL_DONE likewise, finishing at ``dc.time``.

    The MB moved were booked by the commit whose flow drained.  With
    nothing due this is a bit-exact identity."""
    cl, vms, net = dc.cloudlets, dc.vms, dc.net
    vm_ready = ((_owner_field(vms.state, lanes) == VM_ACTIVE)
                & (_owner_field(vms.host, lanes) >= 0)
                & (_owner_field(vms.mig_remaining, lanes) <= 0.0)
                & (cl.vm >= 0))
    live = (net.enabled[:, None] == 1) & (cl.state == CL_CREATED)

    enter_in = (live & vm_ready & (cl.net_phase == NET_PRE)
                & (cl.submit_time <= dc.time[:, None]))
    phase = torch.where(enter_in, NET_STAGE_IN, cl.net_phase)
    lat = torch.where(enter_in, stage_latency(dc)[:, None], cl.net_lat)
    rem = torch.where(enter_in, cl.file_size, cl.net_remaining)

    drained = (lat <= 0.0) & (rem <= 0.0)
    phase = torch.where(live & (phase == NET_STAGE_IN) & drained, NET_RUN,
                        phase)
    done_out = live & (phase == NET_STAGE_OUT) & drained
    return dataclasses.replace(dc, cloudlets=dataclasses.replace(
        cl, net_phase=phase.to(torch.int32), net_lat=lat, net_remaining=rem,
        state=torch.where(done_out, CL_DONE, cl.state).to(torch.int32),
        finish_time=torch.where(done_out, dc.time[:, None],
                                cl.finish_time)))


def lane_transfer_accounting(dc: DatacenterState, drained: torch.Tensor,
                             lanes: Lanes, plan: HostPlan
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(energy_add f32[B, H], moved_mb f32[B]) for the flows ``drained``
    ([B, C]) in this event's commit.

    Each drained transfer books its whole size (``file_size`` in
    NET_STAGE_IN, ``output_size`` in NET_STAGE_OUT), so byte
    conservation carries no rate*dt residue; ``energy_add`` is the
    ``energy_per_mb`` charge on the VM's current host."""
    cl, net = dc.cloudlets, dc.net
    mb = torch.where(drained, torch.where(cl.net_phase == NET_STAGE_IN,
                                          cl.file_size, cl.output_size), 0.0)
    placed = _owner_field(dc.vms.host, lanes) >= 0
    joules = torch.where(placed, mb * net.energy_per_mb[:, None], 0.0)
    per_vm = scheduling.vm_sums(joules.reshape(-1), lanes)
    per_host = scheduling.host_sums(per_vm, plan,
                                    lanes.n_lanes * lanes.n_hosts)
    return (per_host.view(lanes.n_lanes, lanes.n_hosts),
            pairwise_sum(mb))


def lane_route(dc: DatacenterState, src: torch.Tensor, dst: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(bw f32[B], lat f32[B]) of each lane's source -> target migration
    path (``src``/``dst`` i64[B], host ids within the lane)."""
    net = dc.net
    h = net.cluster.shape[-1]
    at = lambda x: net.cluster.gather(
        1, torch.clamp(x, 0, h - 1).long()[:, None])[:, 0]
    same = at(src) == at(dst)
    return (torch.where(same, net.bw_intra, net.bw_inter),
            torch.where(same, net.lat_intra, net.lat_inter))


# ---------------------------------------------------------------------------
# One state (a batch of one lane), under the JAX package's names
# ---------------------------------------------------------------------------
def _one(dc: DatacenterState):
    batch = scheduling.lane_axis(dc)
    return batch, scheduling.lanes_of(batch)


def staging_mask(dc: DatacenterState) -> torch.Tensor:
    """bool[C] — cloudlets with an in-flight staged transfer."""
    return lane_staging(*_one(dc))[0]


def flow_rates(dc: DatacenterState) -> torch.Tensor:
    """f32[C] — MB/s granted to each active transfer this event."""
    return lane_flow_rates(*_one(dc))[0]


def wake_deltas(dc: DatacenterState, frates: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dt_net f32[], flow_dt f32[C]) — the network's event-queue head."""
    batch, lanes = _one(dc)
    dt, flow_dt = lane_wake_deltas(batch, frates[None], lanes)
    return dt[0], flow_dt[0]


def advance_phases(dc: DatacenterState) -> DatacenterState:
    """Every staging-phase transition due at ``dc.time``."""
    return map_tensors(lambda t: t[0], lane_advance_phases(*_one(dc)))


def transfer_accounting(dc: DatacenterState, drained: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(energy_add f32[H], moved_mb f32[]) for the drained flows."""
    batch, lanes = _one(dc)
    plan = scheduling.host_plan(batch, lanes)
    energy_add, moved = lane_transfer_accounting(batch, drained[None],
                                                 lanes, plan)
    return energy_add[0], moved[0]


def migration_route(dc: DatacenterState, src, dst
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(bw f32[], lat f32[]) of the source -> target migration path."""
    batch = scheduling.lane_axis(dc)
    as_lane = lambda x: torch.as_tensor(x, device=dc.time.device).reshape(1)
    bw, lat = lane_route(batch, as_lane(src), as_lane(dst))
    return bw[0], lat[0]
