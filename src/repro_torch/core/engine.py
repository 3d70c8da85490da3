"""Discrete-event engine (``repro.core.engine`` in PyTorch): static,
dynamic and networked scenarios.

Between two events every execution rate is constant, so the event queue
collapses into min-reductions:

    next event = min( t + remaining/rate  over running cloudlets,
                      submit times        of future cloudlets and VMs,
                      times               of pending event-table rows,
                      migration-copy      completions,
                      transfer            latency and payload wakeups,
                      0                   if a migration triggers again )

and the advance is one fused multiply-subtract.  A *full step* is one
event: stage due transfers (``network``), fix every rate (two-level
scheduling, level 2 through the ``simstep`` kernel), pick at most one
migration (``migration``), jump the clock, commit progress, completions,
copy and transfer countdowns, §3.3 costs and per-host joules.

The event-horizon leap (``leap``, on by default as in the JAX engine):
after a full step that ends in a completion, while no decision can
intervene — no arrival, event or copy completion before the next
completion, no completion that would reshuffle a surviving rate
(``_drain_safe``), no migration that could trigger, no enabled topology
— further completions commit on the step's frozen rates, re-masked, with
the step's own f32 arithmetic and no rate pass (``_body``).  Leap on
gives the same bits as leap off.

Every run is a batch of lanes (a single state is a batch of one; see
``core/scheduling.py``), and the host waits for the device once per
block, not once per event.  A step at quiescence is a bit-exact fixed
point, and every other reason for a lane to stop — ``max_steps``,
``horizon``, a VM whose submit time has come, a due event-table row, a
migration that triggered, an open leap window — is masked per lane and
per step on the device: a masked step commits nothing (every ``PEEK``
steps the host reads whether any lane still steps, and ends the block
early when none does).  At a block boundary the host reads one small
tensor: it runs a block of leap
iterations while some lane's window is open, else it applies the due
event rows, the triggered migrations and the provisioning of the lanes
that wait for them, rebuilds the host plan (``scheduling.HostPlan``,
which holds the placement) and runs a block of full steps.  Every pass
that moves a VM runs there, so no full step ever rates with a stale
plan.

A migration takes two full steps and the boundary between them: the
first picks it (``migration.lane_select``) and commits nothing, the
boundary applies it, and the second re-rates the moved state, asks the
policy again (a same-instant cascade bounds that step's dt at 0, the JAX
engine's ``trig_next``) and commits.  So each lane takes the JAX
engine's sequence of events exactly, and the result does not depend on
the blocks.  ``RunStats`` counts the plans built.

Streamed scenarios (``run_stream``; ``core/streaming.py``): a lane's
cloudlet block is a window of recycled slots fed by a chunked arrival
queue.  The admission pass runs on the device at the top of every full
step of a streamed lane, and at a block boundary before the event table
(JAX admits before its step applies the instant's event rows); level 2
reads the window through a regrouped view rebuilt after every pass
(``scheduling.stream_lanes``), and the next unadmitted arrival is an
absolute arrival of ``_full`` and of the leap, whose window a backlog
keeps closed.

Elastic scenarios (an enabled ``AutoscalerState``): the autoscaler is a
pass that moves VMs, so it runs at block boundaries too.  A full step
checks on the device whether the autoscaler would act on the lane
(``_scale_due``) and holds the lane for the boundary when it would; the
boundary evaluates it again on the state after the instant's admission
and event rows, applies it (``_apply_autoscaler``), then provisions, as
the JAX engine's ``step`` orders them.  Spot-segment boundaries are
absolute arrivals, and each commit accrues ``price * fleet * dt``;
enabled lanes never leap.  Probed scenarios (an enabled
``MetricsState``): each commit, of a full step or a leap iteration,
books its interval and its retirements into the plane
(``_probe_commit``) with the same f32 arithmetic, so the plane is the
same bits with the leap on or off.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import (energy, market, metrics, migration, network,
                              scheduling)
from repro_torch import spans
from repro_torch.spans import span
from repro_torch.core.streaming import StreamChunkRecord, StreamRun
from repro_torch.core.migration import Migration
from repro_torch.core.network import wants_network
from repro_torch.core.provisioning import (FIRST_FIT, alive_fleet,
                                           alive_mask, pending_due,
                                           provision_pending)
from repro_torch.core.scheduling import (HostPlan, Lanes, host_plan,
                                         host_sums, lane_axis, lane_min,
                                         lanes_of, refresh_slots,
                                         stream_lanes)
from repro_torch.core.segments import pairwise_sum
from repro_torch.kernels.simstep.ops import simstep
from repro_torch.core.state import (CL_CREATED, CL_DONE, CL_FAILED,
                                    EV_HOST_FAIL, EV_HOST_RECOVER, EV_NONE,
                                    EV_VM_CREATE, EV_VM_DESTROY, INF,
                                    MIG_OFF, MIG_THRESHOLD, NET_STAGE_OUT,
                                    VM_ACTIVE, VM_DESTROYED, VM_EMPTY,
                                    VM_PENDING, ArrivalStream,
                                    DatacenterState, StreamState,
                                    make_stream_states, map_tensors,
                                    tensor_leaves, with_leaves)

__all__ = ["step", "run", "run_stats", "run_trace", "batched_run",
           "batched_run_stats", "run_stream", "run_stream_stats",
           "batched_run_stream", "RunStats", "StepRecord",
           "StreamChunkRecord",
           "apply_due_events", "apply_autoscaler", "wants_dynamic",
           "wants_network",
           "wants_elastic", "wants_probes"]

# completion snap band dt * (1 + 1e-5) + 1e-9, mirrored by the oracle's
# _SNAP_REL/_SNAP_ABS.  The constants are the f32 values the JAX engine
# uses (exact in f32, so torch's scalar casts keep them), applied as an
# f32 multiply then an f32 add.
_SNAP_REL = float(np.float32(1.0 + 1e-5))
_SNAP_ABS = float(np.float32(1e-9))

BLOCK = 32          # most steps (or leap iterations) per host check
PEEK = 8            # inside a block of full steps, steps between reads of
#                     whether any lane still steps
_LEAP_DEFAULT = True


class StepRecord(NamedTuple):
    """Telemetry of one simulation event (``step``)."""
    time: torch.Tensor          # f32[] time *after* the step
    n_running: torch.Tensor     # i32[] cloudlets with rate > 0 during step
    n_done: torch.Tensor        # i32[] cumulative completed cloudlets
    utilization: torch.Tensor   # f32[] consumed MIPS / total host MIPS
    watts: torch.Tensor         # f32[] fleet power drawn during the step
    active: torch.Tensor        # bool[] this step advanced the simulation
    n_migrating: torch.Tensor   # i32[] VMs mid-migration after the step
    migrations: torch.Tensor    # i32[] cumulative migrations
    hosts_down: torch.Tensor    # i32[] real hosts currently failed
    transferred_mb: torch.Tensor  # f32[] cumulative staged MB
    n_flows: torch.Tensor       # i32[] transfers drawing bandwidth
    n_events: torch.Tensor      # i32[] events committed by this step
    #                                   (> 1 when the leap fired)
    fleet: torch.Tensor         # i32[] alive VMs after the step
    spot_cost: torch.Tensor     # f32[] cumulative spot spend


class RunStats(NamedTuple):
    """What a run did besides its final state (summed over lanes)."""
    n_events: int       # committed events: full steps and leap iterations
    n_full: int         # committed full steps
    n_steps: int        # full steps evaluated, masked ones included
    n_leap: int         # leap iterations evaluated, masked ones included
    n_blocks: int       # host checks
    n_plans: int        # host plans built (after placements moved)
    n_passes: int = 0   # admission passes evaluated (streamed runs)
    n_scale: int = 0    # block boundaries where the autoscaler acted


class _Passes(NamedTuple):
    """Which passes a step runs (decided on the host, per run and block)."""
    dynamic: bool       # event table and migration-copy countdowns
    migration: bool     # some lane has a migration policy
    network: bool       # some lane has an enabled topology
    elastic: bool = False   # some lane has an enabled autoscaler or spot
    #                         track: the scaler check and the spot terms
    probed: bool = False    # some lane has an enabled metrics plane


_STATIC = _Passes(False, False, False)


# ---------------------------------------------------------------------------
# The event table (EV_* rows), on every lane of a batch
# ---------------------------------------------------------------------------
def _event_rows(dc: DatacenterState):
    """(time f32[B, E], kind i32[B, E], target i32[B, E]) of the table."""
    ev = dc.events
    return ev[..., 0], ev[..., 1].to(torch.int32), ev[..., 2].to(torch.int32)


def _event_due(dc: DatacenterState) -> torch.Tensor:
    """bool[B] — some unfired event row is due at the lane's clock."""
    if dc.events.shape[-2] == 0:
        return torch.zeros(dc.time.shape, dtype=torch.bool,
                           device=dc.time.device)
    ev_t, ev_k, _ = _event_rows(dc)
    return (~dc.event_fired & (ev_k != EV_NONE)
            & (ev_t <= dc.time[..., None])).any(dim=-1)


def _hit(n: int, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """bool[B, n] — slots targeted by at least one masked event row."""
    return torch.zeros((mask.shape[0], n), dtype=torch.int32,
                       device=mask.device).scatter_add_(
        1, idx, mask.to(torch.int32)) > 0


def _return_pools(dc: DatacenterState, lanes: Lanes, plan: HostPlan,
                  destroy: torch.Tensor):
    """(free_ram, free_bw, free_storage, free_pes) [B, H] with the
    resources of the destroyed VMs (``destroy``, bool[B, V]) that hold a
    host given back to it.  The returns of several VMs of one host add
    in the plan's fixed order (creation time, slot); ``plan`` is the
    host plan of ``dc``."""
    hosts, vms = dc.hosts, dc.vms
    b, h = lanes.n_lanes, lanes.n_hosts
    returning = destroy & (vms.state == VM_ACTIVE) & (vms.host >= 0)

    def give(pool, x):
        back = torch.where(returning, x, 0.0).reshape(-1)
        return pool + host_sums(back, plan, b * h).view(b, h)

    reserve = torch.where(dc.reserve_pes[:, None] == 1,
                          vms.req_pes.to(torch.float32), 0.0)
    return (give(hosts.free_ram, vms.ram), give(hosts.free_bw, vms.bw),
            give(hosts.free_storage, vms.size),
            give(hosts.free_pes, reserve))


def _apply_events(dc: DatacenterState, lanes: Lanes, plan: HostPlan,
                  mask: torch.Tensor) -> DatacenterState:
    """``apply_due_events`` on the lanes ``mask`` (bool[B]); ``plan`` is
    the host plan of ``dc``.

    Kind order within one instant: VM destroys (resources back to their
    hosts), VM creates (EMPTY -> PENDING), host failures (pools reset,
    resident VMs evicted back to PENDING with their cloudlets' progress
    kept), host recoveries.  The returns of several VMs destroyed on one
    host add in the plan's fixed order.  With nothing due this is a
    bit-exact identity."""
    if dc.events.shape[-2] == 0:
        return dc
    hosts, vms, cl = dc.hosts, dc.vms, dc.cloudlets
    b, h, v = lanes.n_lanes, lanes.n_hosts, lanes.n_vms
    ev_t, ev_k, tgt = _event_rows(dc)
    due = (~dc.event_fired & (ev_k != EV_NONE)
           & (ev_t <= dc.time[:, None]) & mask[:, None])
    # rows with out-of-range targets fire but act on nothing
    due_v = due & (tgt >= 0) & (tgt < v)
    due_h = due & (tgt >= 0) & (tgt < h)
    tv = torch.clamp(tgt, 0, max(v - 1, 0)).long()
    th = torch.clamp(tgt, 0, max(h - 1, 0)).long()

    # ---- 1. VM destroys ---------------------------------------------------
    destroy = (_hit(v, tv, due_v & (ev_k == EV_VM_DESTROY))
               & alive_mask(vms))
    free_ram, free_bw, free_storage, free_pes = _return_pools(
        dc, lanes, plan, destroy)
    vm_state = torch.where(destroy, VM_DESTROYED, vms.state)
    vm_host = torch.where(destroy, -1, vms.host)
    mig_rem = torch.where(destroy, 0.0, vms.mig_remaining)

    # ---- 2. VM creates ----------------------------------------------------
    create = (_hit(v, tv, due_v & (ev_k == EV_VM_CREATE))
              & (vm_state == VM_EMPTY))
    vm_state = torch.where(create, VM_PENDING, vm_state)

    # ---- 3. host failures -------------------------------------------------
    real = hosts.num_pes > 0
    fail = (_hit(h, th, due_h & (ev_k == EV_HOST_FAIL)) & hosts.valid
            & real)
    evict = ((vm_state == VM_ACTIVE) & (vm_host >= 0)
             & fail.gather(1, torch.clamp(vm_host, 0, h - 1).long()))
    vm_state = torch.where(evict, VM_PENDING, vm_state)
    vm_create_t = torch.where(evict, INF, vms.create_time)
    vm_host = torch.where(evict, -1, vm_host)
    mig_rem = torch.where(evict, 0.0, mig_rem)
    cap_pes = hosts.num_pes.to(torch.float32)

    def reset(mask_h, pools):
        return [torch.where(mask_h, full, pool) for pool, full in zip(
            pools, (hosts.ram, hosts.bw, hosts.storage, cap_pes))]

    valid = hosts.valid & ~fail
    pools = reset(fail, (free_ram, free_bw, free_storage, free_pes))

    # ---- 4. host recoveries -----------------------------------------------
    recover = (_hit(h, th, due_h & (ev_k == EV_HOST_RECOVER)) & ~valid
               & real)
    valid = valid | recover
    free_ram, free_bw, free_storage, free_pes = reset(recover, pools)

    # cloudlets of destroyed VMs can never run
    owner = torch.clamp(cl.vm, 0, max(v - 1, 0)).long()
    cancel = ((cl.state == CL_CREATED) & (cl.vm >= 0)
              & destroy.gather(1, owner))
    i32 = lambda t: t.to(torch.int32)
    return dataclasses.replace(
        dc,
        hosts=dataclasses.replace(
            hosts, free_ram=free_ram, free_bw=free_bw,
            free_storage=free_storage, free_pes=free_pes, valid=valid),
        vms=dataclasses.replace(
            vms, state=i32(vm_state), host=i32(vm_host),
            create_time=vm_create_t, mig_remaining=mig_rem),
        cloudlets=dataclasses.replace(
            cl, state=i32(torch.where(cancel, CL_FAILED, cl.state))),
        event_fired=dc.event_fired | due)


def apply_due_events(dc: DatacenterState) -> DatacenterState:
    """Apply every pending event row due at ``dc.time`` and mark the rows
    fired (one state).  ``vms.submit_time`` is never rewritten: evicted
    VMs re-provision at once (their submit times are due), created ones
    at ``max(event time, submit_time)``.  With every row fired this is a
    bit-exact identity."""
    batch = lane_axis(dc)
    lanes = lanes_of(batch)
    mask = torch.ones((1,), dtype=torch.bool, device=dc.time.device)
    out = _apply_events(batch, lanes, host_plan(batch, lanes), mask)
    return map_tensors(lambda t: t[0], out)


# ---------------------------------------------------------------------------
# The autoscaler, on every lane of a batch
# ---------------------------------------------------------------------------
class _Scale(NamedTuple):
    """The autoscaler's reading of each lane (``_scale_terms``)."""
    want_up: torch.Tensor       # bool[B]
    want_down: torch.Tensor     # bool[B]
    empty: torch.Tensor         # bool[B, V] VM_EMPTY slots
    drained: torch.Tensor       # bool[B, V] alive, no unfinished cloudlet,
    #                             not mid-migration
    up_quota: torch.Tensor      # i32[B]
    down_quota: torch.Tensor    # i32[B]


def _scale_terms(dc: DatacenterState) -> _Scale:
    """What ``apply_autoscaler`` reads, per lane.  Utilization is the
    integer ratio of busy ACTIVE VMs (>= 1 cloudlet runnable now) over
    alive ones; actions need work (a ``CL_CREATED`` cloudlet), the
    cooldown passed, and for a scale-up a price within the spot
    sensitivity.  The per-VM counts are integer scatters, exact in any
    order."""
    vms, cl, sc = dc.vms, dc.cloudlets, dc.scaler
    b, v = vms.state.shape
    dev = vms.state.device
    alive = alive_mask(vms)
    fleet = alive.sum(dim=-1, dtype=torch.int32)
    owner = (torch.clamp(cl.vm, 0, max(v - 1, 0)).long()
             + torch.arange(b, device=dev)[:, None] * v).reshape(-1)
    assigned = (cl.state == CL_CREATED) & (cl.vm >= 0)
    current = (assigned & (cl.submit_time <= dc.time[:, None])
               & (cl.remaining > 0.0))
    counts = torch.zeros((b * v, 2), dtype=torch.int32,
                         device=dev).index_add_(
        0, owner, torch.stack([assigned, current], dim=-1).reshape(
            -1, 2).to(torch.int32)).view(b, v, 2)
    busy = (vms.state == VM_ACTIVE) & (counts[..., 1] > 0)
    util = (busy.sum(dim=-1, dtype=torch.int32).to(torch.float32)
            / torch.clamp(fleet, min=1).to(torch.float32))
    work = (cl.state == CL_CREATED).any(dim=-1)
    ready = (dc.time - sc.last_action) >= sc.cooldown
    price = market.spot_price_at(sc, dc.time)
    price_ok = ((sc.spot_enabled == 0) | (sc.price_sensitivity <= 0.0)
                | (price <= sc.price_sensitivity))
    want_up = (work & ready & (util > sc.util_high)
               & (fleet < sc.max_fleet) & price_ok)
    want_down = (~want_up & work & ready & (util < sc.util_low)
                 & (fleet > sc.min_fleet))
    return _Scale(
        want_up=want_up, want_down=want_down,
        empty=vms.state == VM_EMPTY,
        drained=alive & (counts[..., 0] == 0) & (vms.mig_remaining <= 0.0),
        up_quota=torch.minimum(sc.scale_step, sc.max_fleet - fleet),
        down_quota=torch.minimum(sc.scale_step, fleet - sc.min_fleet))


def _scale_due(dc: DatacenterState) -> torch.Tensor:
    """bool[B] — lanes whose enabled autoscaler would act now: a wanted
    scale-up with some EMPTY slot to create, or a wanted scale-down with
    some drained VM to destroy (with nothing to do, ``apply_autoscaler``
    is a bit-exact identity)."""
    t = _scale_terms(dc)
    return (dc.scaler.enabled == 1) & (
        (t.want_up & t.empty.any(dim=-1) & (t.up_quota >= 1))
        | (t.want_down & t.drained.any(dim=-1) & (t.down_quota >= 1)))


def _apply_autoscaler(dc: DatacenterState, lanes: Lanes, plan: HostPlan,
                      mask: torch.Tensor) -> DatacenterState:
    """``apply_autoscaler`` on the lanes ``mask`` (bool[B]); ``plan`` is
    the host plan of ``dc``.  A scale-up turns the lowest-index EMPTY
    slots PENDING (their build-time submit times are kept); a scale-down
    destroys the highest-index drained VMs with ``EV_VM_DESTROY``'s
    rules, their resources back to their hosts in the plan's order."""
    t = _scale_terms(dc)
    vms, cl, sc = dc.vms, dc.cloudlets, dc.scaler
    v = vms.state.shape[1]
    create = ((mask & t.want_up)[:, None] & t.empty
              & (torch.cumsum(t.empty.to(torch.int32), dim=-1)
                 <= t.up_quota[:, None]))
    rank_hi = torch.flip(torch.cumsum(torch.flip(
        t.drained.to(torch.int32), dims=[-1]), dim=-1), dims=[-1])
    destroy = ((mask & t.want_down)[:, None] & t.drained
               & (rank_hi <= t.down_quota[:, None]))
    n_up = create.sum(dim=-1, dtype=torch.int32)
    n_down = destroy.sum(dim=-1, dtype=torch.int32)
    free_ram, free_bw, free_storage, free_pes = _return_pools(
        dc, lanes, plan, destroy)
    # drained VMs hold no unfinished cloudlet, so this cancel is a no-op
    # (kept from the event pass's destroy, as the JAX engine keeps it)
    owner = torch.clamp(cl.vm, 0, max(v - 1, 0)).long()
    cancel = ((cl.state == CL_CREATED) & (cl.vm >= 0)
              & destroy.gather(1, owner))
    i32 = lambda x: x.to(torch.int32)
    return dataclasses.replace(
        dc,
        hosts=dataclasses.replace(
            dc.hosts, free_ram=free_ram, free_bw=free_bw,
            free_storage=free_storage, free_pes=free_pes),
        vms=dataclasses.replace(
            vms,
            state=i32(torch.where(destroy, VM_DESTROYED, torch.where(
                create, VM_PENDING, vms.state))),
            host=i32(torch.where(destroy, -1, vms.host)),
            mig_remaining=torch.where(destroy, 0.0, vms.mig_remaining)),
        cloudlets=dataclasses.replace(
            cl, state=i32(torch.where(cancel, CL_FAILED, cl.state))),
        scaler=dataclasses.replace(
            sc,
            last_action=torch.where((n_up + n_down) > 0, dc.time,
                                    sc.last_action),
            up_count=sc.up_count + n_up,
            down_count=sc.down_count + n_down))


def apply_autoscaler(dc: DatacenterState) -> DatacenterState:
    """One closed-loop evaluation of the autoscaler on one state (the
    JAX engine's ``apply_autoscaler``): outside the cooldown, ``util >
    util_high`` creates up to ``scale_step`` lowest-index EMPTY slots and
    ``util < util_low`` destroys up to ``scale_step`` highest-index
    drained VMs, within the fleet bounds; a spot track with
    ``price_sensitivity > 0`` vetoes scale-ups above it.  With no action
    due this is a bit-exact identity."""
    batch = lane_axis(dc)
    lanes = lanes_of(batch)
    mask = torch.ones((1,), dtype=torch.bool, device=dc.time.device)
    out = _apply_autoscaler(batch, lanes, host_plan(batch, lanes), mask)
    return map_tensors(lambda t: t[0], out)


def _lane_elastic(batch: DatacenterState) -> torch.Tensor:
    """bool[B] — lanes with an enabled autoscaler or spot track
    (constant over a run)."""
    return (batch.scaler.enabled == 1) | (batch.scaler.spot_enabled == 1)


def _dynamic_deltas(dc: DatacenterState, trig_next):
    """(dt f32[B], arrive f32[B]) — each lane's earliest dynamic wakeup:
    migration-copy completions (deltas) and a zero-dt chain event when a
    migration triggers again on the moved state (``trig_next``, bool[B]
    or None); the earliest pending event-table time (absolute)."""
    t = dc.time
    if dc.events.shape[-2]:
        ev_t, ev_k, _ = _event_rows(dc)
        pend = ~dc.event_fired & (ev_k != EV_NONE) & (ev_t > t[:, None])
        arr_ev = lane_min(torch.where(pend, ev_t, INF))
    else:
        arr_ev = torch.full_like(t, INF)
    mig = dc.vms.mig_remaining
    dt = lane_min(torch.where(mig > 0.0, mig, INF))
    if trig_next is not None:
        dt = torch.minimum(dt, torch.where(trig_next, 0.0, INF))
    return dt, arr_ev


def _lane_dynamic(batch: DatacenterState) -> torch.Tensor:
    """bool[B] — lanes that can still act dynamically: a migration
    policy, a copy in flight or an unfired event row.  Monotone: once
    False, False for the rest of the run."""
    lane = (batch.mig_policy != MIG_OFF) | (batch.vms.mig_remaining
                                            > 0.0).any(dim=-1)
    if batch.events.shape[-2]:
        _, kinds, _ = _event_rows(batch)
        lane |= (~batch.event_fired & (kinds != EV_NONE)).any(dim=-1)
    return lane


# ---------------------------------------------------------------------------
# One event, on every lane of a batch
# ---------------------------------------------------------------------------
def _arrivals(dc: DatacenterState) -> torch.Tensor:
    """f32[B] earliest future submit time (cloudlet or VM) of each lane.

    Absolute table values, so an arrival that wins the queue sets the
    clock exactly."""
    cl, vms = dc.cloudlets, dc.vms
    t = dc.time[:, None]
    future_cl = (cl.state == CL_CREATED) & (cl.submit_time > t)
    future_vm = (vms.state == VM_PENDING) & (vms.submit_time > t)
    return torch.minimum(lane_min(torch.where(future_cl, cl.submit_time,
                                              INF)),
                         lane_min(torch.where(future_vm, vms.submit_time,
                                              INF)))


def _with_stream(arrive: torch.Tensor, dc: DatacenterState, next_arrival
                 ) -> torch.Tensor:
    """``arrive`` with a stream's next unadmitted arrival (f32[B] or
    None) as an absolute arrival.  A backlogged one (submit at or
    before the clock, the window full) is no event: a completion frees
    a slot first, and the next admission pass takes it."""
    if next_arrival is None:
        return arrive
    return torch.minimum(arrive, torch.where(next_arrival > dc.time,
                                             next_arrival, INF))


def _sla_bound(dc: DatacenterState, lanes: Lanes) -> torch.Tensor:
    """f32[B, C] each cloudlet's SLA response bound: the plane's factor
    times its length over its VM's requested MIPS."""
    mips = dc.vms.req_mips.reshape(-1)[lanes.slot_vm].view_as(
        dc.cloudlets.length)
    ideal = dc.cloudlets.length / torch.clamp(mips, min=1e-30)
    return dc.metrics.sla_factor[:, None] * ideal


def _retire(m, pre: DatacenterState, new: DatacenterState, lanes: Lanes,
            was_done: torch.Tensor):
    """``m`` with the cloudlets DONE in ``new`` and not in ``was_done``
    booked (``metrics.fill_retirement``)."""
    ncl = new.cloudlets
    return metrics.fill_retirement(
        m, newly=(ncl.state == CL_DONE) & ~was_done,
        finish=ncl.finish_time, submit=ncl.submit_time,
        start=ncl.start_time, bound=_sla_bound(pre, lanes))


def _probe_commit(pre: DatacenterState, new: DatacenterState, lanes: Lanes,
                  plan: HostPlan, rates, consumed, host_watts, dt, frates,
                  was_done):
    """The metrics plane of ``new`` after one commit from ``pre`` (the
    state whose ``rates`` it used; every observable is constant on
    ``[pre.time, new.time)``).  ``consumed`` is each host's MIPS
    (``scheduling.host_consumed``, f64[B*H]); a lane's sums over hosts
    run in a fixed order (``pairwise_sum``, in f64), so a lane gives the
    same bits alone or in a batch; ``was_done`` is the DONE mask the
    step started from."""
    b, h = lanes.n_lanes, lanes.n_hosts
    hosts, cl = pre.hosts, pre.cloudlets
    valid_mips = torch.where(hosts.valid, hosts.capacity_mips, 0.0)
    used, watts, host_mips = pairwise_sum(torch.stack([
        consumed.view(b, h), host_watts.double(),
        valid_mips.double()])).to(torch.float32)
    util = used / torch.clamp(host_mips, min=1e-30)
    backlog = ((cl.state == CL_CREATED)
               & (cl.submit_time <= pre.time[:, None])
               & (cl.remaining > 0.0) & (rates <= 0.0)).sum(
        dim=-1, dtype=torch.int32)
    busy = torch.zeros((b * h,), dtype=torch.int32,
                       device=rates.device).index_add_(
        0, plan.slot_host, (rates > 0.0).to(torch.int32).reshape(-1)) > 0
    flows = (torch.zeros_like(backlog) if frates is None
             else (frates > 0.0).sum(dim=-1, dtype=torch.int32))
    m = metrics.accrue_interval(
        pre.metrics, t0=pre.time, t1=new.time, util=util, watts=watts,
        fleet=alive_fleet(pre.vms).to(torch.float32), backlog=backlog,
        flows=flows, busy_hosts=busy.view(b, h).to(torch.float32), dt=dt)
    return _retire(m, pre, new, lanes, was_done)


def _commit(dc: DatacenterState, lanes: Lanes, plan: HostPlan, rates,
            finish_dt, dt, t_next, *, stamp_start: bool,
            passes: _Passes = _STATIC, flows=None, was_done=None):
    """The commit of one event at ``rates`` ([B, C]) over ``dt`` ([B]),
    clock to ``t_next``.  ``flows`` is (flow rates, flow deltas) of the
    networked step; ``was_done`` the DONE mask the step started from
    (probed passes).  Returns (new state, host watts f32[B, H], copies
    done bool[B, V] or None)."""
    cl = dc.cloudlets
    executed = rates * dt[:, None]
    snap = dt * _SNAP_REL + _SNAP_ABS
    snap_c = snap[:, None]
    # the argmin task(s) finish by construction, immune to f32 rounding
    finished = ((cl.state == CL_CREATED) & (rates > 0.0)
                & (finish_dt <= snap_c))
    remaining = torch.where(finished, 0.0,
                            torch.clamp(cl.remaining - executed, min=0.0))
    start_time = cl.start_time
    if stamp_start:
        start_time = torch.where((rates > 0.0) & (cl.start_time < 0.0),
                                 dc.time[:, None], cl.start_time)
    done_now = finished
    staged = {}
    if flows is not None:
        # enabled lanes: a compute completion arms the output transfer
        # (advance_phases marks it done once drained); the latency and
        # payload countdowns take the completions' snap band
        frates, flow_dt = flows
        enabled = dc.net.enabled[:, None] == 1
        done_now = finished & ~enabled
        arm_out = finished & enabled
        lat_active = network.lane_staging(dc, lanes) & (cl.net_lat > 0.0)
        lat_done = lat_active & (cl.net_lat <= snap_c)
        net_lat = torch.where(lat_done, 0.0, torch.where(
            lat_active, torch.clamp(cl.net_lat - dt[:, None], min=0.0),
            cl.net_lat))
        xfer_done = (frates > 0.0) & (flow_dt <= snap_c)
        net_rem = torch.where(xfer_done, 0.0, torch.where(
            frates > 0.0,
            torch.clamp(cl.net_remaining - frates * dt[:, None], min=0.0),
            cl.net_remaining))
        staged = dict(
            net_phase=torch.where(arm_out, NET_STAGE_OUT,
                                  cl.net_phase).to(torch.int32),
            net_lat=torch.where(arm_out, network.stage_latency(dc)[:, None],
                                net_lat),
            net_remaining=torch.where(arm_out, cl.output_size, net_rem))

    # market accounting (§3.3), summed per lane in a fixed order
    pe = executed / torch.clamp(plan.slot_mips_pe.view_as(executed),
                                min=1e-30)
    moved = torch.where(done_now, cl.file_size + cl.output_size, 0.0)
    pe_seconds, moved_mb = pairwise_sum(torch.stack([pe, moved]))

    # energy: rates, hence watts, are constant on [time, time + dt)
    consumed = scheduling.host_consumed(rates.reshape(-1), lanes, plan)
    host_watts = energy.host_power(dc.hosts, energy.utilization_of(
        dc.hosts, consumed))
    energy_j = dc.hosts.energy_j + host_watts * dt[:, None]
    bw_cost = dc.acct.bw_cost + dc.rates.cost_per_bw * moved_mb
    transferred = dc.net_transferred_mb
    if flows is not None:
        # drained transfers book their whole size on this step
        xfer_j, xfer_mb = network.lane_transfer_accounting(
            dc, xfer_done, lanes, plan)
        energy_j = energy_j + xfer_j
        bw_cost = bw_cost + dc.rates.cost_per_bw * xfer_mb
        transferred = transferred + xfer_mb

    vms, mig_done = dc.vms, None
    if passes.dynamic:
        # the migration copy counts down like a cloudlet's remaining,
        # with the same snap band
        mig = vms.mig_remaining
        mig_done = (mig > 0.0) & (mig <= snap_c)
        vms = dataclasses.replace(vms, mig_remaining=torch.where(
            mig_done, 0.0, torch.where(
                mig > 0.0, torch.clamp(mig - dt[:, None], min=0.0), mig)))

    scaler = dc.scaler
    if passes.elastic:
        # spot spend: price and fleet are constant on [time, time + dt)
        # (boundaries are events), so price * fleet * dt is exact; zero
        # price while the track is disabled
        spot_rate = (market.spot_price_at(scaler, dc.time)
                     * alive_fleet(dc.vms).to(torch.float32))
        scaler = dataclasses.replace(
            scaler, spot_cost=scaler.spot_cost + spot_rate * dt)

    new = dataclasses.replace(
        dc,
        hosts=dataclasses.replace(dc.hosts, energy_j=energy_j),
        vms=vms,
        cloudlets=dataclasses.replace(
            cl, remaining=remaining, start_time=start_time,
            finish_time=torch.where(done_now, t_next[:, None],
                                    cl.finish_time),
            state=torch.where(done_now, CL_DONE, cl.state).to(torch.int32),
            **staged),
        acct=dataclasses.replace(
            dc.acct,
            cpu_cost=dc.acct.cpu_cost
            + dc.rates.cost_per_cpu_sec * pe_seconds,
            bw_cost=bw_cost),
        time=t_next,
        net_transferred_mb=transferred,
        scaler=scaler)
    if passes.probed:
        new = dataclasses.replace(new, metrics=_probe_commit(
            dc, new, lanes, plan, rates, consumed, host_watts, dt,
            flows[0] if flows is not None else None, was_done))
    return new, host_watts, mig_done


class _Step(NamedTuple):
    """What one full step of every lane gives back."""
    new: DatacenterState        # the committed state
    active: torch.Tensor        # bool[B] the step advanced the lane
    rates: torch.Tensor         # f32[B, C] the committed rates
    host_watts: torch.Tensor    # f32[B, H]
    counts: torch.Tensor        # i32[B*V] runnable cloudlets a VM, before
    opens: torch.Tensor         # bool[B] the leap's gate before _drain_safe
    hold: torch.Tensor | None   # bool[B] a migration triggered: no commit
    mig: Migration | None       # each lane's decision
    phased: DatacenterState     # the state after the staging phases
    frates: torch.Tensor | None  # f32[B, C] transfer rates


def _quiet(new: DatacenterState, rates, lanes: Lanes, plan: HostPlan
           ) -> torch.Tensor:
    """bool[B] — no migration can trigger while completions drain on the
    frozen rates: the policy is off, or THRESHOLD with no loaded host
    over the threshold (utilization only falls as completions drop
    out; DRAIN triggers on falling load, so DRAIN lanes never leap)."""
    cl = new.cloudlets
    r1 = torch.where((cl.state == CL_CREATED) & (cl.remaining > 0.0),
                     rates, 0.0)
    util = energy.utilization_of(new.hosts, scheduling.host_consumed(
        r1.reshape(-1), lanes, plan))
    loaded = new.hosts.valid & (plan.occupancy.view_as(util) > 0)
    over = (loaded & (util > new.mig_threshold[:, None])).any(dim=-1)
    return ((new.mig_policy == MIG_OFF)
            | ((new.mig_policy == MIG_THRESHOLD) & ~over))


def _full(dc: DatacenterState, lanes: Lanes, plan: HostPlan,
          passes: _Passes = _STATIC, after=None, next_arrival=None
          ) -> _Step:
    """One full step of every lane, provisioning and the event table
    excluded.  ``after`` (bool[B]) marks lanes whose migration was just
    applied: their policy's answer is the cascade's ``trig_next``,
    which bounds the step's dt at 0; on the other lanes a trigger holds
    the lane (``_Step.hold``) for the boundary to apply.
    ``next_arrival`` (f32[B]) is each streamed lane's next unadmitted
    arrival; a backlog (one at or before the new clock) keeps the leap's
    window shut, since any completion would make its admission due.
    Probed passes book the staging drains that complete at the top of
    the step (``advance_phases``) with the phases, so a held lane keeps
    them booked once."""
    was_done = None
    if passes.probed:
        was_done = dc.cloudlets.state == CL_DONE
    if passes.network:
        dc = network.lane_advance_phases(dc, lanes)
        if passes.probed:
            dc = dataclasses.replace(dc, metrics=_retire(
                dc.metrics, dc, dc, lanes, was_done))
            was_done = dc.cloudlets.state == CL_DONE
    phased = dc
    rates, dt_finish, counts = scheduling.lane_rates(
        dc, lanes, plan, networked=passes.network)
    cl = dc.cloudlets
    # per-slot completion deltas: the kernel's quotient elementwise
    finish_dt = torch.where(rates > 0.0,
                            cl.remaining / torch.clamp(rates, min=1e-30), INF)
    arrive = _with_stream(_arrivals(dc), dc, next_arrival)
    if passes.elastic:
        # spot-segment boundaries are absolute arrivals (exact f32 table
        # values); INF while the track is disabled
        arrive = torch.minimum(arrive, market.next_spot_boundary(dc.scaler,
                                                                 dc.time))
    dt_other = dt_finish
    hold = mig = trig_next = None
    if passes.dynamic:
        if passes.migration:
            mig = migration.lane_select(dc, rates, lanes, plan,
                                        networked=passes.network)
            hold = mig.trigger & ~after
            trig_next = mig.trigger & after
        dt_dyn, arr_ev = _dynamic_deltas(dc, trig_next)
        dt_other = torch.minimum(dt_other, dt_dyn)
        arrive = torch.minimum(arrive, arr_ev)
    flows = frates = None
    if passes.network:
        frates = network.lane_flow_rates(dc, lanes)
        dt_net, flow_dt = network.lane_wake_deltas(dc, frates, lanes)
        dt_other = torch.minimum(dt_other, dt_net)
        flows = (frates, flow_dt)
    dt_arr = torch.where(arrive < INF, arrive - dc.time, INF)
    dt = torch.minimum(dt_other, dt_arr)
    active = dt < INF
    dt = torch.where(active, dt, 0.0)
    # arrivals win ties so the clock lands on the exact submitted time
    t_next = torch.where(active,
                         torch.where(dt_arr <= dt_other, arrive,
                                     dc.time + dt),
                         dc.time)
    new, host_watts, mig_done = _commit(dc, lanes, plan, rates, finish_dt,
                                        dt, t_next, stamp_start=True,
                                        passes=passes, flows=flows,
                                        was_done=was_done)
    # a window can commit only while some cloudlet keeps its rate
    survivors = ((rates > 0.0)
                 & (new.cloudlets.state == CL_CREATED)).any(dim=-1)
    opens = (active & (dt_arr > dt_other) & (arrive > new.time)
             & survivors)
    if next_arrival is not None:
        opens &= next_arrival > new.time
    if passes.dynamic:
        opens &= ~mig_done.any(dim=-1)
        if passes.migration:
            opens &= ~trig_next & _quiet(new, rates, lanes, plan)
    if passes.network:
        opens &= dc.net.enabled != 1
    if passes.elastic:
        # the autoscaler decides at every event and spot boundaries are
        # events: enabled lanes never leap
        opens &= (dc.scaler.enabled == 0) & (dc.scaler.spot_enabled == 0)
    return _Step(new, active, rates, host_watts, counts, opens, hold, mig,
                 phased, frates)


def _drain_safe(n_pre, post: DatacenterState, lanes: Lanes,
                plan: HostPlan, *, networked: bool = False):
    """(bool[B], ``run_counts`` of ``post``) — per lane, the commit from
    a state with ``n_pre`` runnable cloudlets a VM to ``post`` cannot
    change any surviving rate.

    A completion reshuffles the shares in two ways.  VM-level reshare: a
    VM running more task units than PEs re-splits its capacity when one
    finishes; safe only when ``n_runnable <= req_pes``.  Eligibility
    flip: without ``reserve_pes`` a VM that drains its last runnable unit
    stops competing for its host; safe when the VM keeps work, PEs are
    reserved, or the VM is alone on its host.  Conservative: False
    forgoes a leap, never corrupts one.
    """
    n_post = scheduling.run_counts(
        scheduling.lane_runnable(post, lanes, networked=networked), lanes)
    safe = (n_post == n_pre) | ((n_pre <= plan.pes)
                                & ((n_post >= 1) | plan.keeps_work))
    return safe.view(lanes.n_lanes, lanes.n_vms).all(dim=-1), n_post


def _body(dc: DatacenterState, lanes: Lanes, plan: HostPlan, r0, n_now,
          go, passes: _Passes = _STATIC, next_arrival=None):
    """One leap iteration on the lanes ``go``: the next completion (or
    copy completion) on the frozen rates ``r0`` ([B, C]), re-masked
    (survivors keep their exact f32 rate, guaranteed by ``_drain_safe``;
    finished ones drop out).  It commits only when no arrival or event
    comes first and it is drain-safe; a finished copy commits and closes
    the window (the VM resumes, rates grow).  ``n_now`` is
    ``run_counts`` of ``dc``; a streamed lane's ``next_arrival`` closes
    the window before it.  Returns (state, committed bool[B], still
    open bool[B], ``run_counts`` of the candidate)."""
    cl = dc.cloudlets
    r = torch.where((cl.state == CL_CREATED) & (cl.remaining > 0.0), r0,
                    0.0)
    finish_dt = torch.where(r > 0.0,
                            cl.remaining / torch.clamp(r, min=1e-30), INF)
    dt_o = lane_min(finish_dt)
    arr = _with_stream(_arrivals(dc), dc, next_arrival)
    if passes.elastic:
        arr = torch.minimum(arr, market.next_spot_boundary(dc.scaler,
                                                           dc.time))
    if passes.dynamic:
        dt_dyn, arr_ev = _dynamic_deltas(dc, None)
        dt_o = torch.minimum(dt_o, dt_dyn)
        arr = torch.minimum(arr, arr_ev)
    d_arr = torch.where(arr < INF, arr - dc.time, INF)
    dt = torch.minimum(dt_o, d_arr)
    act = dt < INF
    dt = torch.where(act, dt, 0.0)
    t_next = dc.time + dt
    # enabled networked and elastic lanes never leap: the static commit
    # serves, with the probes of a full step
    frozen = _Passes(passes.dynamic, False, False, probed=passes.probed)
    cand, _, mig_done = _commit(
        dc, lanes, plan, r, finish_dt, dt, t_next, stamp_start=False,
        passes=frozen,
        was_done=(cl.state == CL_DONE) if passes.probed else None)
    safe, n_post = _drain_safe(n_now, cand, lanes, plan,
                               networked=passes.network)
    do = go & act & (d_arr > dt_o) & (arr > t_next) & safe
    going = do
    if mig_done is not None:
        going = do & ~mig_done.any(dim=-1)
    return _select(do, cand, dc, frozen), do, going, n_post


def _select(go: torch.Tensor, new: DatacenterState, old: DatacenterState,
            passes: _Passes = _STATIC, inplace: bool = False
            ) -> DatacenterState:
    """Lane by lane, ``new`` where ``go`` else ``old``, for the fields a
    step writes (the passes at block boundaries write the others); with
    ``inplace``, into ``old``'s own tensors (a captured step's buffers)."""
    w = lambda a, b: torch.where(go.view(go.shape + (1,) * (a.ndim - 1)),
                                 a, b, out=b if inplace else None)
    nc, oc = new.cloudlets, old.cloudlets
    cl_fields = ["remaining", "start_time", "finish_time", "state"]
    if passes.network:
        cl_fields += ["net_phase", "net_lat", "net_remaining"]
    vms = old.vms
    if passes.dynamic:
        vms = dataclasses.replace(vms, mig_remaining=w(
            new.vms.mig_remaining, vms.mig_remaining))
    scaler, plane = old.scaler, old.metrics
    if passes.elastic:
        scaler = dataclasses.replace(scaler, spot_cost=w(
            new.scaler.spot_cost, old.scaler.spot_cost))
    if passes.probed:
        plane = metrics.MetricsState(**{
            f.name: w(getattr(new.metrics, f.name), getattr(plane, f.name))
            for f in dataclasses.fields(plane)})
    return dataclasses.replace(
        old,
        scaler=scaler,
        metrics=plane,
        hosts=dataclasses.replace(
            old.hosts, energy_j=w(new.hosts.energy_j, old.hosts.energy_j)),
        vms=vms,
        cloudlets=dataclasses.replace(oc, **{
            f: w(getattr(nc, f), getattr(oc, f)) for f in cl_fields}),
        acct=dataclasses.replace(
            old.acct, cpu_cost=w(new.acct.cpu_cost, old.acct.cpu_cost),
            bw_cost=w(new.acct.bw_cost, old.acct.bw_cost)),
        time=w(new.time, old.time),
        net_transferred_mb=(w(new.net_transferred_mb,
                              old.net_transferred_mb)
                            if passes.network else old.net_transferred_mb))


def _where_lanes(go: torch.Tensor, new: torch.Tensor, old: torch.Tensor,
                 lanes: Lanes, inplace: bool = False) -> torch.Tensor:
    """[B*X] ``new`` on the entries of the lanes ``go``, else ``old``;
    with ``inplace``, into ``old`` itself."""
    into = old.view(lanes.n_lanes, -1)
    out = torch.where(go[:, None], new.view(lanes.n_lanes, -1), into,
                      out=into if inplace else None)
    return old if inplace else out.view(-1)


def _provision_lanes(batch: DatacenterState, which, policy: int
                     ) -> DatacenterState:
    """``provision_pending`` on the lanes ``which``, one after another;
    each leaf it changes is rebuilt once."""
    spans.count("provision.lanes", len(which))
    old = tensor_leaves(batch)
    new = list(old)
    for b in which:
        lane = map_tensors(lambda t: t[b], batch)
        before = tensor_leaves(lane)
        after = tensor_leaves(provision_pending(lane, policy))
        for i, (x, y) in enumerate(zip(before, after)):
            if y is not x:
                if new[i] is old[i]:
                    new[i] = old[i].clone()
                new[i][b] = y
    return with_leaves(batch, new)


# ---------------------------------------------------------------------------
# Which passes a scenario needs
# ---------------------------------------------------------------------------
def wants_dynamic(dc: DatacenterState) -> bool:
    """True when the scenario carries an event table, a migration policy,
    or an in-flight migration."""
    if dc.events.shape[-2] > 0:
        return True
    with span("sync.passes.mig_policy"):
        if bool((dc.mig_policy != 0).any()):
            return True
    with span("sync.passes.mig_remaining"):
        return bool((dc.vms.mig_remaining > 0.0).any())


def wants_elastic(dc: DatacenterState) -> bool:
    """True when the scenario carries an enabled autoscaler or spot track."""
    with span("sync.passes.scaler"):
        if bool((dc.scaler.enabled != 0).any()):
            return True
    with span("sync.passes.spot"):
        return bool((dc.scaler.spot_enabled != 0).any())


def wants_probes(dc: DatacenterState) -> bool:
    """True when the scenario carries an enabled metrics plane."""
    with span("sync.passes.probes"):
        return bool((dc.metrics.enabled != 0).any())


def _passes_of(dc: DatacenterState) -> _Passes:
    """The passes a run of ``dc`` (one state or a batch) may need: the
    JAX engine's ``wants_dynamic``/``wants_network``/``wants_elastic``/
    ``wants_probes``, and whether any lane has a migration policy at
    all."""
    dynamic = migrates = wants_dynamic(dc)
    if dynamic:
        with span("sync.passes.migration"):
            migrates = bool((dc.mig_policy != MIG_OFF).any())
    return _Passes(dynamic=dynamic, migration=migrates,
                   network=wants_network(dc), elastic=wants_elastic(dc),
                   probed=wants_probes(dc))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def step(dc: DatacenterState, *, provision_policy: int = FIRST_FIT,
         leap: bool = False, leap_budget=None, leap_horizon=None,
         streaming: bool = False, next_arrival=None
         ) -> tuple[DatacenterState, StepRecord]:
    """Process one simulation event; with ``leap``, also the run of
    completions that follows it while no decision can intervene (at most
    ``leap_budget`` more, none at or past ``leap_horizon``), counted in
    ``StepRecord.n_events``.

    ``streaming``: the cloudlet block is a window of recycled slots
    (``run_stream``), read through its regrouped view, and
    ``next_arrival`` (the submit time of the stream's next unadmitted
    arrival, or INF) joins the event queue as an absolute arrival;
    admission itself happens between steps.

    In order, as the JAX engine's ``step``: due event rows, the
    autoscaler, provisioning, staging phases, rates, at most one
    migration (and the rates again), flow rates, the commit (with the
    spot accrual and the probes).  At quiescence (no runnable work, no
    future submissions, no pending events or transfers) the state comes
    back bit-for-bit unchanged with ``active == False``.
    """
    passes = _passes_of(dc)
    batch = lane_axis(dc)
    lanes = lanes_of(batch, streaming=streaming)
    dev = batch.time.device
    nxt = None
    if streaming and next_arrival is not None:
        nxt = torch.as_tensor(next_arrival, dtype=torch.float32,
                              device=dev).reshape(1)
    if passes.dynamic and bool(_event_due(batch)[0]):
        batch = _apply_events(batch, lanes, host_plan(batch, lanes),
                              torch.ones((1,), dtype=torch.bool, device=dev))
    if passes.elastic and bool(_scale_due(batch)[0]):
        batch = _apply_autoscaler(
            batch, lanes, host_plan(batch, lanes),
            torch.ones((1,), dtype=torch.bool, device=dev))
    if bool(pending_due(batch)[0]):
        batch = lane_axis(provision_pending(
            map_tensors(lambda t: t[0], batch), provision_policy))
    plan = host_plan(batch, lanes)
    after = torch.zeros((1,), dtype=torch.bool, device=dev)
    st = _full(batch, lanes, plan, passes, after, nxt)
    if st.hold is not None and bool(st.hold[0]):
        batch = migration.lane_apply(st.phased, st.mig)
        plan = host_plan(batch, lanes)
        st = _full(batch, lanes, plan, passes, ~after, nxt)
    new, active, rates = st.new, st.active, st.rates
    n_events = active.to(torch.int32)
    if leap:
        budget = torch.as_tensor(2 ** 30 if leap_budget is None
                                 else leap_budget, device=dev)
        horizon = torch.clamp(torch.as_tensor(
            INF if leap_horizon is None else leap_horizon,
            dtype=torch.float32, device=dev), max=INF)
        safe, n_now = _drain_safe(st.counts, new, lanes, plan,
                                  networked=passes.network)
        window = st.opens & safe
        extra = torch.zeros_like(n_events)
        while bool(window.any()):
            for _ in range(BLOCK):
                go = window & (extra < budget) & (new.time < horizon)
                new, do, window, n_post = _body(new, lanes, plan, rates,
                                                n_now, go, passes, nxt)
                extra = extra + do.to(torch.int32)
                n_now = _where_lanes(do, n_post, n_now, lanes)
        n_events = n_events + extra
    new = map_tensors(lambda t: t[0], new)
    rates = rates[0]
    hosts = batch.hosts
    valid_mips = torch.where(hosts.valid[0], hosts.capacity_mips[0], 0.0)
    count = lambda m: m.sum(dtype=torch.int32)
    rec = StepRecord(
        time=new.time,
        n_running=count(rates > 0.0),
        n_done=count(new.cloudlets.state == CL_DONE),
        utilization=rates.sum() / torch.clamp(valid_mips.sum(), min=1e-30),
        watts=st.host_watts[0].sum(),
        active=active[0],
        n_migrating=count(new.vms.mig_remaining > 0.0),
        migrations=new.mig_count,
        hosts_down=count(~new.hosts.valid & (new.hosts.num_pes > 0)),
        transferred_mb=new.net_transferred_mb,
        n_flows=(count(st.frates[0] > 0.0) if st.frates is not None
                 else torch.zeros((), dtype=torch.int32, device=dev)),
        n_events=n_events[0],
        fleet=alive_fleet(new.vms),
        spot_cost=new.scaler.spot_cost)
    return new, rec


# ---------------------------------------------------------------------------
# A block of full steps: one iteration, eager or replayed as a CUDA graph
# ---------------------------------------------------------------------------
class _Carry(NamedTuple):
    """What ``_drive``'s full steps carry from one to the next."""
    batch: DatacenterState
    n: torch.Tensor         # i32[B] committed events
    n_full: torch.Tensor    # i32[B] committed full steps
    used: torch.Tensor      # i32[B] steps the lane took in this block
    alive: torch.Tensor     # bool[B] the last committed step was active
    window: torch.Tensor    # bool[B] a leap window is open
    r0: torch.Tensor        # f32[B, C] the open window's frozen rates
    n_now: torch.Tensor     # i32[B*V] its run_counts
    held: torch.Tensor      # bool[B] a triggered migration waits
    after: torch.Tensor     # bool[B] the lane's migration was just applied
    scaled: torch.Tensor    # bool[B] the autoscaler was evaluated on the
    #                         state the lane's next full step starts from
    pend: Migration | None  # the decisions of the held lanes


def _gate(c: _Carry, ready: torch.Tensor, bp: _Passes) -> torch.Tensor:
    """bool[B] — the ``ready`` lanes that take the next full step: those
    that no boundary pass waits for."""
    go = ready & ~pending_due(c.batch) & ~c.window
    if bp.dynamic:
        go &= ~_event_due(c.batch) & ~c.held
    if bp.elastic:
        # a lane whose autoscaler would act waits for the boundary
        go &= ~(_scale_due(c.batch) & ~(c.scaled | c.after))
    return go


def _advance(c: _Carry, go: torch.Tensor, lanes: Lanes, plan: HostPlan,
             bp: _Passes, *, leap: bool, max_steps: int, hor: torch.Tensor,
             nxt=None, stream: StreamRun | None = None,
             inplace: bool = False) -> _Carry:
    """One full step of the lanes ``go``: the step, its leap gate, the
    commit's select and the carries' updates.  With ``inplace``, what it
    writes goes into ``c``'s own tensors (``_buffers``) instead of new
    ones: the form a captured step takes (``_StepGraph``)."""
    batch, n, n_full, used, alive, window, r0, n_now, held, after, scaled, \
        pend = c
    out = (lambda t: t) if inplace else (lambda t: None)
    st = _full(batch, lanes, plan, bp, after, nxt)
    commit = go
    if st.hold is not None:
        hold = go & st.hold
        commit = go & ~hold
        held = held | hold
        pend = st.mig if pend is None else Migration(*(
            torch.where(hold, a, b) for a, b in zip(st.mig, pend)))
        after = after & ~commit
    if bp.elastic:
        scaled = scaled & ~commit
    done = (commit & st.active).to(torch.int32)
    if leap:
        safe, n_post = _drain_safe(st.counts, st.new, lanes, plan,
                                   networked=bp.network)
        gate = (commit & st.opens & safe & (n + done < max_steps)
                & (st.new.time < hor))
        if stream is not None:
            gate &= stream.n_chunk + done < stream.max_steps
        window = torch.bitwise_or(window, gate, out=out(window))
        r0 = torch.where(gate[:, None], st.rates, r0, out=out(r0))
        n_now = _where_lanes(gate, n_post, n_now, lanes, inplace)
    new = _select(commit, st.new, batch, bp, inplace)
    if st.hold is not None and bp.network:
        # a held lane keeps its staging phases
        new = _select(hold, st.phased, new, bp)
    c = _Carry(new, torch.add(n, done, out=out(n)),
               torch.add(n_full, done, out=out(n_full)),
               torch.add(used, go.to(torch.int32), out=out(used)),
               torch.where(commit, st.active, alive, out=out(alive)),
               window, r0, n_now, held, after, scaled, pend)
    if stream is not None:
        stream.commit(commit, st.active, done)
    return c


def _written(dc: DatacenterState) -> list[torch.Tensor]:
    """The leaves a static full step writes (``_select`` of ``_STATIC``)."""
    cl = dc.cloudlets
    return [dc.hosts.energy_j, cl.remaining, cl.start_time, cl.finish_time,
            cl.state, dc.acct.cpu_cost, dc.acct.bw_cost, dc.time]


def _buffers(c: _Carry) -> list[torch.Tensor]:
    """The tensors a static full step writes: its leaves and carries."""
    return _written(c.batch) + [c.n, c.n_full, c.used, c.alive, c.window,
                                c.r0, c.n_now]


def _reads(dc: DatacenterState) -> list:
    """``tensor_leaves`` of ``dc`` with None for the ``_written`` ones:
    the leaves a static full step only reads."""
    cl, none = dc.cloudlets, None
    return tensor_leaves(dataclasses.replace(
        dc, hosts=dataclasses.replace(dc.hosts, energy_j=none),
        cloudlets=dataclasses.replace(cl, remaining=none, start_time=none,
                                      finish_time=none, state=none),
        acct=dataclasses.replace(dc.acct, cpu_cost=none, bw_cost=none),
        time=none))


def _graphable(device: torch.device, stream, bp: _Passes) -> bool:
    """Whether a block of full steps replays one captured step
    (``_StepGraph``): on a CUDA device, with no stream (admission
    rebuilds the flat axes at every step) and only the static passes
    (the others write leaves and carries besides ``_buffers``).  A
    plan's first step runs eagerly, and the capture follows it."""
    return device.type == "cuda" and stream is None and bp == _STATIC


_KEPT: dict[int, tuple] = {}   # device index -> (anchor graph, stream)


def _kept(device: torch.device):
    """(memory pool, side stream) that every captured step on ``device``
    shares.

    A graph's pool outlives its graphs: once the last one is dropped, the
    caching allocator keeps the pool's memory, unused, until an
    allocation fails (28.5 MB a call at 100,000 hosts and 2 lanes); and a
    block freed in a pool serves later allocations on its own stream
    only.  So one pool, held by a one-node graph, and one capture stream
    are kept a device: each capture reuses the memory of the one before,
    and no tensor is held between captures."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _KEPT:
        anchor, side = torch.cuda.CUDAGraph(), torch.cuda.Stream(index)
        with torch.cuda.stream(side):
            anchor.capture_begin()
            torch.zeros((), device=index)   # an empty capture warns
            anchor.capture_end()
        _KEPT[index] = anchor, side
    anchor, side = _KEPT[index]
    return anchor.pool(), side


class _StepGraph:
    """A static block's full step as two CUDA graphs on one memory pool:
    the gate leaves the lanes that step in ``go``, the step advances them,
    written in place into the carry's buffers (``_buffers``).

    The buffers are the carry of an eager step that ``_drive`` ran, never
    a caller's tensors; the leaves the step only reads, the flat axes and
    the plan are captured by address, so the graph holds while ``fits``.
    ``simstep.launches`` counts a replay's kernel launches, and not the
    capture's."""

    def __init__(self, c: _Carry, lanes: Lanes, plan: HostPlan,
                 bp: _Passes, gate, advance):
        self.carry, self.lanes, self.plan, self.bp = c, lanes, plan, bp
        self.reads = _reads(c.batch)
        before = simstep.launches
        self._gate, self.go, self._step, out = self._capture(c, gate,
                                                             advance)
        self.launches = simstep.launches - before
        simstep.launches = before
        if ([t.data_ptr() for t in _buffers(out)]
                != [t.data_ptr() for t in _buffers(c)]):
            raise RuntimeError("the captured step wrote a carry out of place")

    @staticmethod
    def _capture(c: _Carry, gate, advance):
        """(the gate's replay, its ``go``, the step's replay, what the
        captured step returned): ``gate(c)`` and ``advance(c, go)``
        captured on the device's kept stream and pool (``_kept``), their
        device work not run."""
        dev = c.batch.time.device
        main = torch.cuda.current_stream(dev)
        pool, side = _kept(dev)
        graphs, outs = [], []
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for fn in (lambda: gate(c), lambda: advance(c, outs[0])):
                graphs.append(torch.cuda.CUDAGraph())
                graphs[-1].capture_begin(pool=pool)
                try:
                    outs.append(fn())
                finally:
                    graphs[-1].capture_end()
        main.wait_stream(side)
        return graphs[0].replay, outs[0], graphs[1].replay, outs[1]

    def fits(self, c: _Carry, lanes: Lanes, plan: HostPlan, bp: _Passes
             ) -> bool:
        return (bp == self.bp and lanes is self.lanes and plan is self.plan
                and all(a is b for a, b in zip(_reads(c.batch), self.reads)))

    def load(self, c: _Carry) -> _Carry:
        """``c`` in the graph's buffers (a carry rebound since, by the
        leap or a new block, is copied in)."""
        for buf, t in zip(_buffers(self.carry), _buffers(c)):
            if t is not buf:
                buf.copy_(t)
        self.carry = self.carry._replace(held=c.held, after=c.after,
                                         scaled=c.scaled, pend=c.pend)
        return self.carry

    def replay_gate(self) -> torch.Tensor:
        self._gate()
        return self.go

    def replay_step(self) -> _Carry:
        self._step()
        simstep.launches += self.launches
        spans.count("graph.replays")
        return self.carry


@spans.spanned("drive")
def _drive(batch: DatacenterState, *, max_steps: int, horizon: float,
           provision_policy: int, leap: bool, block: int,
           passes: _Passes, stream: StreamRun | None = None
           ) -> tuple[DatacenterState, RunStats]:
    """Run every lane of ``batch`` to quiescence (see the module's
    docstring).  ``passes`` are the most a run may need; each block runs
    only those some live lane still needs.  With ``stream``, every lane
    is a streamed lane: it lives while its chunks last (JAX's chunk
    loop, ``StreamRun``), not until its first inactive step, and
    ``max_steps`` and ``horizon`` give way to ``max_steps_per_chunk``.

    Spans (``repro_torch.spans``): ``drive.lanes``; a block's
    ``drive.read``, then ``drive.leap`` (a ``step.leap`` an iteration) or
    ``drive.boundary`` (``drive.admit``, ``drive.events``,
    ``drive.autoscale``, ``drive.migrate``, ``drive.provision``, a
    ``drive.plan`` a plan counted in ``n_plans``) and ``drive.steps`` (a
    ``step.full`` a step counted in ``n_steps``, ``drive.peek``);
    ``drive.stats``; ``sync.drive.*`` around each wait for the device.

    On a CUDA device a block of static full steps replays one captured
    step (``_graphable``, ``_StepGraph``): captured after the first eager
    step on a plan (in ``drive.capture``, counted in ``graph.captures``),
    replayed until a boundary moves a VM (``graph.replays``), dropped on
    return.  The results are the eager steps' bits."""
    if block < 1:
        raise ValueError("block must be >= 1")
    dev = batch.time.device
    with span("drive.lanes"):
        lanes = lanes_of(batch, streaming=stream is not None)
    nb = lanes.n_lanes
    with span("sync.drive.horizon"):
        hor = torch.clamp(torch.tensor(horizon, dtype=torch.float32,
                                       device=dev), max=INF)
    i32 = lambda: torch.zeros((nb,), dtype=torch.int32, device=dev)
    no = lambda: torch.zeros((nb,), dtype=torch.bool, device=dev)
    n, n_full, used = i32(), i32(), i32()
    alive = torch.ones((nb,), dtype=torch.bool, device=dev)
    window, held, after = no(), no(), no()
    scaled = no()       # the autoscaler was evaluated at the boundary on
    #                     the state the lane's next full step starts from
    pend = None         # the decisions of the held lanes
    r0 = torch.zeros(batch.cloudlets.remaining.shape, dtype=torch.float32,
                     device=dev)
    n_now = torch.zeros((nb * lanes.n_vms,), dtype=torch.int32, device=dev)
    plan = None
    nxt = None          # each streamed lane's next unadmitted arrival
    steps_len, leap_len, kind = block, 1, None
    n_steps = n_leap = n_blocks = n_plans = n_scale = 0
    fixed = dict(leap=leap, max_steps=max_steps, hor=hor)
    graph = None        # the block's captured full step (_StepGraph)

    def gate(c):
        # the lanes of an unstreamed run that take the next full step
        return _gate(c, c.alive & (c.n < max_steps) & (c.batch.time < hor),
                     bp)

    def admit(batch, lanes, plan, mask, ends=False):
        # the admission pass, then the regrouped view it changed
        with span("drive.admit"):
            batch = stream.begin(batch, mask, ends=ends)
            lanes = stream_lanes(batch, lanes)
            if plan is not None:
                plan = refresh_slots(batch, plan, lanes)
            return batch, lanes, plan, stream.next_arrival()

    def new_plan(batch, lanes):
        with span("drive.plan"):
            return host_plan(batch, lanes)

    while True:
        with span("drive.read"):
            if stream is None:
                live = alive & (n < max_steps) & (batch.time < hor)
            else:
                live = stream.live()
            rows = dict(live=live, due=live & pending_due(batch),
                        window=window, used=used, held=held)
            if passes.dynamic:
                rows.update(ev=live & _event_due(batch),
                            dyn=live & _lane_dynamic(batch))
            if passes.network:
                rows.update(net=live & (batch.net.enabled == 1))
            if passes.elastic:
                rows.update(ela=live & _lane_elastic(batch))
            if passes.probed:
                rows.update(prb=live & (batch.metrics.enabled == 1))
            if stream is not None:
                rows.update(ends=live & stream.ending())
            stacked = torch.stack([r.to(torch.int32) for r in rows.values()])
            with span("sync.drive.read"):
                read = dict(zip(rows, stacked.tolist()))
            del stacked     # its block is free for the boundary's tensors
        live_h, due_h, window_h, used_h, held_h = (
            read[k] for k in ("live", "due", "window", "used", "held"))
        ev_h, ends_h = read.get("ev", [0]), read.get("ends", [0])
        dyn_now = any(read.get("dyn", [0]))
        bp = _Passes(dyn_now, passes.migration and dyn_now,
                     any(read.get("net", [0])), any(read.get("ela", [0])),
                     any(read.get("prb", [0])))
        n_blocks += 1
        most = max(used_h)
        if any(window_h):
            # a block of leap iterations.  A new window starts with one
            # (most windows close at their first iteration) and doubles
            # while it stays open; the next step block is as long as the
            # steps it took to open this one
            if kind == "step":
                steps_len, leap_len = max(1, most), 1
            else:
                leap_len = min(block, 2 * leap_len)
            with span("drive.leap"):
                used = torch.zeros_like(used)
                for _ in range(leap_len):
                    with span("step.leap"):
                        go = window & (n < max_steps) & (batch.time < hor)
                        if stream is not None:
                            go &= stream.budget()
                        batch, do, window, n_post = _body(
                            batch, lanes, plan, r0, n_now, go, bp, nxt)
                        if stream is not None:
                            stream.leap(do)
                        n = n + do.to(torch.int32)
                        used = used + do.to(torch.int32)
                        n_now = _where_lanes(do, n_post, n_now, lanes)
            n_leap += leap_len
            kind = "leap"
            continue
        if kind == "step":
            steps_len = min(block, 2 * steps_len)   # no window opened
        if not any(live_h):
            break
        with span("drive.boundary"):
            # the passes that move VMs: due event rows, the held
            # migrations, then provisioning; the plan is rebuilt once
            # after them.  In an instant, admission comes first: the
            # lanes they act on finish their pass before them, as do the
            # lanes whose chunk ends here
            if stream is not None and (any(ev_h) or any(due_h)
                                       or any(ends_h)):
                with span("sync.drive.waits"):
                    waits = torch.tensor([e or d or x for e, d, x in zip(
                        ev_h, due_h, ends_h)], device=dev)
                while True:
                    batch, lanes, plan, nxt = admit(batch, lanes, plan,
                                                    live & ~window,
                                                    ends=True)
                    n_blocks += 1
                    with span("sync.drive.admitting"):
                        admitting = bool((waits & stream.admitting()).any())
                    if not admitting:
                        break
            moved = False
            if any(ev_h):
                if plan is None:
                    plan = new_plan(batch, lanes)
                    n_plans += 1
                with span("drive.events"):
                    with span("sync.drive.ev"):
                        ev = torch.tensor(ev_h, dtype=torch.bool, device=dev)
                    batch = _apply_events(batch, lanes, plan, ev)
                    del ev
                    with span("sync.drive.due"):
                        due_h = (live & pending_due(batch)).tolist()
                moved = True
            if bp.elastic:
                # the autoscaler, on the state after the instant's
                # admission and event rows, of every lane about to take a
                # full step that starts an instant (a held lane and the
                # re-rated step after a migration are past it)
                with span("drive.autoscale"):
                    scaled = live & ~window & ~held & ~after
                    if stream is not None:
                        scaled &= stream.ready()
                    scale = scaled & _scale_due(batch)
                    with span("sync.drive.scale"):
                        acts = bool(scale.any())
                if acts:
                    if moved or plan is None:
                        plan = new_plan(batch, lanes)
                        n_plans += 1
                    with span("drive.autoscale"):
                        batch = _apply_autoscaler(batch, lanes, plan, scale)
                        with span("sync.drive.due"):
                            due_h = (live & pending_due(batch)).tolist()
                    moved = True
                    n_scale += 1
            if any(held_h):
                with span("drive.migrate"):
                    batch = migration.lane_apply(batch, pend._replace(
                        trigger=pend.trigger & held))
                    after, held = after | held, no()
                # the re-rated step, then the cascade's next decision
                steps_len = min(steps_len, 2)
                moved = True
            due_lanes = [b for b, due in enumerate(due_h) if due]
            if due_lanes:
                with span("drive.provision"):
                    batch = _provision_lanes(batch, due_lanes,
                                             provision_policy)
                moved = True
            if moved or plan is None:
                plan = new_plan(batch, lanes)
                n_plans += 1
        with span("drive.steps"):
            c = _Carry(batch, n, n_full, torch.zeros_like(used), alive,
                       window, r0, n_now, held, after, scaled, pend)
            del batch       # the carry holds the state a step starts from
            graphed = _graphable(dev, stream, bp)
            if graph is not None:
                if graph.fits(c, lanes, plan, bp):
                    c = graph.load(c)
                else:
                    graph = None
            for i in range(steps_len):
                if graphed and graph is None and i:
                    # the step before ran eagerly on this block's plan
                    with span("drive.capture"):
                        graph = _StepGraph(c, lanes, plan, bp, gate,
                                           lambda c, go: _advance(
                                               c, go, lanes, plan, bp,
                                               inplace=True, **fixed))
                        spans.count("graph.captures")
                if graph is not None:
                    go = graph.replay_gate()
                elif stream is None:
                    go = gate(c)
                else:
                    batch, lanes, plan, nxt = admit(c.batch, lanes, plan,
                                                    ~c.window)
                    c = c._replace(batch=batch)
                    del batch
                    go = _gate(c, stream.ready(), bp)
                if i and i % PEEK == 0:
                    # every lane may be waiting for the boundary already
                    n_blocks += 1
                    with span("drive.peek"), span("sync.drive.peek"):
                        stepping = bool(go.any())
                    if not stepping:
                        break
                with span("step.full"):
                    if graph is not None:
                        c = graph.replay_step()
                    else:
                        c = _advance(c, go, lanes, plan, bp, nxt=nxt,
                                     stream=stream, **fixed)
                n_steps += 1
            (batch, n, n_full, used, alive, window, r0, n_now, held, after,
             scaled, pend) = c
        kind = "step"
    with span("drive.stats"), span("sync.drive.stats"):
        n_events, full = torch.stack([n.sum(), n_full.sum()]).tolist()
    return batch, RunStats(n_events=n_events, n_full=full, n_steps=n_steps,
                           n_leap=n_leap, n_blocks=n_blocks, n_plans=n_plans,
                           n_passes=stream.n_passes if stream else 0,
                           n_scale=n_scale)


def run_stats(dc: DatacenterState, *, max_steps: int = 1_000_000,
              horizon: float = float("inf"),
              provision_policy: int = FIRST_FIT, leap: bool | None = None,
              block: int = BLOCK) -> tuple[DatacenterState, RunStats]:
    """``run``, also returning what it did (``RunStats``)."""
    out, stats = _drive(lane_axis(dc), max_steps=max_steps,
                        horizon=horizon, provision_policy=provision_policy,
                        leap=_LEAP_DEFAULT if leap is None else leap,
                        block=block, passes=_passes_of(dc))
    return map_tensors(lambda t: t[0], out), stats


def run(dc: DatacenterState, *, max_steps: int = 1_000_000,
        horizon: float = float("inf"), provision_policy: int = FIRST_FIT,
        leap: bool | None = None, block: int = BLOCK) -> DatacenterState:
    """Run a scenario to quiescence.

    Stops when the event queue is empty (no runnable work, no future
    submissions, no pending event rows, copies or transfers), once the
    clock has passed ``horizon`` (simulated seconds), or after
    ``max_steps`` events, as the JAX engine's ``run`` does; ``leap``
    (default on) as there.  At most ``block`` steps run between two host
    checks; the result does not depend on it.
    """
    return run_stats(dc, max_steps=max_steps, horizon=horizon,
                     provision_policy=provision_policy, leap=leap,
                     block=block)[0]


def batched_run_stats(batch: DatacenterState, *, max_steps: int,
                      horizon: float = float("inf"),
                      provision_policy: int = FIRST_FIT,
                      leap: bool | None = None, block: int = BLOCK
                      ) -> tuple[DatacenterState, RunStats]:
    """``batched_run``, also returning what it did (``RunStats``, summed
    over lanes)."""
    return _drive(batch, max_steps=max_steps, horizon=horizon,
                  provision_policy=provision_policy,
                  leap=_LEAP_DEFAULT if leap is None else leap, block=block,
                  passes=_passes_of(batch))


def batched_run(batch: DatacenterState, *, max_steps: int,
                horizon: float = float("inf"),
                provision_policy: int = FIRST_FIT, leap: bool | None = None,
                block: int = BLOCK) -> DatacenterState:
    """Run a batched state (leading lane axis, ``sweep.stack_scenarios``)
    to quiescence.

    Each lane is masked on ``alive & n < max_steps & time < horizon``,
    finished lanes are frozen by a per-lane select, and the loop ends
    when no lane is live.  Every pass runs once for all lanes (one
    simstep launch a full step), a block runs the dynamic, networked,
    elastic and probe passes only while a live lane needs them, and lane
    i equals ``run`` of that scenario bit for bit.
    """
    return batched_run_stats(batch, max_steps=max_steps, horizon=horizon,
                             provision_policy=provision_policy, leap=leap,
                             block=block)[0]


def run_trace(dc: DatacenterState, *, num_steps: int,
              provision_policy: int = FIRST_FIT
              ) -> tuple[DatacenterState, StepRecord]:
    """Run exactly ``num_steps`` events (leap off), keeping telemetry.

    Returns ``(final state, StepRecord trace)`` with every trace leaf
    stacked to [num_steps].  Steps past quiescence are no-ops flagged
    ``active=False``.  One host sync a step.
    """
    if num_steps < 1:
        raise ValueError("num_steps must be >= 1")
    records = []
    for _ in range(num_steps):
        dc, rec = step(dc, provision_policy=provision_policy)
        records.append(rec)
    return dc, StepRecord(*(torch.stack(leaf) for leaf in zip(*records)))


# ---------------------------------------------------------------------------
# Streamed arrivals (core/streaming.py)
# ---------------------------------------------------------------------------
def batched_run_stream(batch: DatacenterState, streams: ArrivalStream, *,
                       reservoir: int = 64,
                       provision_policy: int = FIRST_FIT,
                       leap: bool | None = None,
                       max_steps_per_chunk: int = 4096, block: int = BLOCK
                       ) -> tuple[DatacenterState, StreamState,
                                  StreamChunkRecord, RunStats]:
    """``run_stream`` on every lane of a batch: ``batch``'s cloudlet
    blocks are windows, ``streams`` a stacked [B, K, M] queue
    (``sweep.stack_streams``).  Returns (final state, ``StreamState``,
    per-chunk records [B, K], ``RunStats``); lane i equals the single
    ``run_stream`` of its scenario bit for bit."""
    n_vms = batch.vms.req_pes.shape[-1]
    n_slots = batch.cloudlets.vm.shape[-1]
    run = StreamRun(streams, make_stream_states(streams, n_vms, n_slots,
                                                reservoir=reservoir),
                    n_slots=n_slots, max_steps_per_chunk=max_steps_per_chunk)
    out, stats = _drive(batch, max_steps=2 ** 31 - 1, horizon=INF,
                        provision_policy=provision_policy,
                        leap=_LEAP_DEFAULT if leap is None else leap,
                        block=block, passes=_passes_of(batch), stream=run)
    st, recs = run.finish(out)
    return out, st, recs, stats


def run_stream_stats(dc: DatacenterState, stream: ArrivalStream, *,
                     reservoir: int = 64, provision_policy: int = FIRST_FIT,
                     leap: bool | None = None,
                     max_steps_per_chunk: int = 4096, block: int = BLOCK
                     ) -> tuple[DatacenterState, StreamState,
                                StreamChunkRecord, RunStats]:
    """``run_stream``, also returning what it did (``RunStats``)."""
    out, st, recs, stats = batched_run_stream(
        lane_axis(dc), map_tensors(lambda t: t.unsqueeze(0), stream),
        reservoir=reservoir, provision_policy=provision_policy, leap=leap,
        max_steps_per_chunk=max_steps_per_chunk, block=block)
    one = lambda tree: map_tensors(lambda t: t[0], tree)
    return (one(out), one(st), StreamChunkRecord(*(r[0] for r in recs)),
            stats)


def run_stream(dc: DatacenterState, stream: ArrivalStream, *,
               reservoir: int = 64, provision_policy: int = FIRST_FIT,
               leap: bool | None = None, max_steps_per_chunk: int = 4096,
               block: int = BLOCK
               ) -> tuple[DatacenterState, StreamState, StreamChunkRecord]:
    """Run a streamed-arrival scenario to quiescence.

    ``dc`` carries the infrastructure and an empty window
    (``state.make_window(W)``), ``stream`` the workload as chunked
    arrivals (``state.make_stream``).  W bounds the cloudlets in flight
    (arrivals past it queue, FCFS); the chunk size changes no result.
    Each chunk runs until its rows are admitted and the clock reaches
    the next chunk's head, an inactive step, or ``max_steps_per_chunk``
    events, as in the JAX engine.  Returns (final state,
    ``StreamState``, per-chunk ``StreamChunkRecord`` [K]): the workload's
    answers are in ``StreamState.stats``, energy and costs on the state.
    """
    return run_stream_stats(dc, stream, reservoir=reservoir,
                            provision_policy=provision_policy, leap=leap,
                            max_steps_per_chunk=max_steps_per_chunk,
                            block=block)[:3]
