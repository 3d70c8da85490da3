"""Two-level VM/cloudlet scheduling (``repro.core.scheduling`` in PyTorch).

Level 1 (host -> VM, the VMScheduler) grants each VM a share of its
host's MIPS; level 2 (VM -> cloudlet, the CloudletScheduler) divides the
VM's share among its task units.  Each level is SPACE_SHARED or
TIME_SHARED, the 2x2 matrix of the paper's Figure 3.

Every pass works on a batch of lanes at once: a state whose leaves carry
a leading lane axis [B, ...] (one scenario a lane; a single state is a
batch of one).  Hosts, VMs and cloudlets are flattened to [B*H], [B*V]
and [B*C], lane b's VM ids offset by b*V and its host ids by b*H, so
every sort, sum and kernel launch runs once for the whole batch:

  * ``Lanes`` holds each slot's global VM, the rows of the flat
    cloudlet axis (``row_index``) and each row's task policy.  A
    resident run builds it once; a streamed window, whose admissions
    recycle slots across VMs, rebuilds it on the device after every
    admission pass (``stream_lanes``) through a regrouped view ``perm``:
    the slots sorted by (lane, VM, ``rank_in_vm``);
  * ``HostPlan`` holds what changes only when VMs are placed: the VMs
    sorted by (host, creation time, slot), each VM's demand and each
    cloudlet's host.

Level 2 runs through the ``simstep`` kernel, which reads the flat
grouped-by-VM cloudlet axis directly (each VM's slots are one contiguous
run; on a streamed window, the regrouped view) with a task policy per
row: one launch per pass, whatever the number of lanes.

Sums of floats per host and per lane run in a fixed order
(``segments.run_scan``, ``segments.pairwise_sum``), never through
``index_add_``, whose CUDA atomics add in no fixed order.  So a lane of
a batch gives the same bits as the same scenario run alone.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.segments import (rounds_for, run_scan, run_starts,
                                       segment_cumsum)
from repro_torch.core.state import (CL_CREATED, INF, NET_RUN, SPACE_SHARED,
                                    VM_ACTIVE, DatacenterState, map_tensors)
from repro_torch.kernels.simstep.ops import (RowIndex, padded_row_index,
                                             row_index, simstep_ragged)

__all__ = ["cloudlet_runnable", "vm_has_work", "host_level_shares",
           "vm_level_rates", "cloudlet_rates", "rates_and_dt", "Lanes",
           "lanes_of", "stream_lanes", "HostPlan", "host_plan",
           "refresh_slots", "host_sums",
           "host_consumed", "vm_sums", "lane_axis", "lane_rates",
           "lane_min", "lane_runnable", "run_counts",
           "segment_cumsum_grouped"]

# The JAX package's back-compat name for the grouped cumsum, which lives
# in ``segments``.
segment_cumsum_grouped = segment_cumsum


def lane_axis(dc: DatacenterState) -> DatacenterState:
    """A single state as a batch of one lane (views, no copy)."""
    return map_tensors(lambda t: t.unsqueeze(0), dc)


@dataclasses.dataclass
class Lanes:
    """The flat axes of a batched run.  A resident run keeps them from
    start to end (its ``cl.vm`` never changes); a streamed one rebuilds
    the slot fields after each admission pass (``stream_lanes``), and
    ``index`` and ``slot_rel`` then describe the regrouped view: slot
    ``perm[p]`` at position ``p``."""
    n_lanes: int
    n_hosts: int                # per lane
    n_vms: int
    n_cloudlets: int
    slot_vm: torch.Tensor       # i64[B*C] global VM of each slot, clamped
    index: RowIndex             # the B*V rows of the flat cloudlet axis
    row_policy: torch.Tensor    # i32[B*V] each row's task policy
    space_rows: torch.Tensor    # bool[B*V] its lane's vm_policy is SPACE
    reserve_rows: torch.Tensor  # bool[B*V] its lane reserves PEs
    slot_rel: torch.Tensor      # i64[B*C] slot - its row's first slot (0
    #                             for a slot of no row)
    row_rounds: int             # run_scan rounds for the longest row
    perm: torch.Tensor | None = None    # i64[B*C] the regrouped view's
    #                                     slot order (streamed windows)


def lanes_of(dc: DatacenterState, *, streaming: bool = False) -> Lanes:
    """``Lanes`` of a batched state (two host syncs; none when
    ``streaming``, whose slot fields ``stream_lanes`` builds)."""
    if streaming:
        b, c = dc.cloudlets.vm.shape
        v = dc.vms.req_pes.shape[1]
        empty = torch.zeros((0,), dtype=torch.long, device=dc.time.device)
        return stream_lanes(dc, Lanes(
            n_lanes=b, n_hosts=dc.hosts.num_pes.shape[1], n_vms=v,
            n_cloudlets=c, slot_vm=empty, index=None,
            row_policy=dc.task_policy.to(torch.int32).repeat_interleave(v),
            space_rows=(dc.vm_policy == SPACE_SHARED).repeat_interleave(v),
            reserve_rows=(dc.reserve_pes == 1).repeat_interleave(v),
            slot_rel=empty, row_rounds=rounds_for(c)))
    b, c = dc.cloudlets.vm.shape
    v = dc.vms.req_pes.shape[1]
    h = dc.hosts.num_pes.shape[1]
    dev = dc.time.device
    vm = dc.cloudlets.vm.long()
    base = torch.arange(b, device=dev)[:, None] * v
    in_row = (vm >= 0) & (vm < v)
    slot_vm = (torch.clamp(vm, 0, max(v - 1, 0)) + base).reshape(-1)
    slot_row = torch.where(in_row, vm + base, -1).reshape(-1)
    index = row_index(slot_row.to(torch.int32), b * v)
    row = index.slot_row.long()
    first = (index.start.long()[torch.clamp(row, min=0)] if index.n_rows
             else torch.zeros_like(row))
    longest = int(index.length.max()) if index.n_rows else 0
    return Lanes(
        n_lanes=b, n_hosts=h, n_vms=v, n_cloudlets=c, slot_vm=slot_vm,
        index=index,
        row_policy=dc.task_policy.to(torch.int32).repeat_interleave(v),
        space_rows=(dc.vm_policy == SPACE_SHARED).repeat_interleave(v),
        reserve_rows=(dc.reserve_pes == 1).repeat_interleave(v),
        slot_rel=torch.where(row >= 0, torch.arange(b * c, device=dev)
                             - first, 0),
        row_rounds=rounds_for(longest))


def stream_lanes(dc: DatacenterState, lanes: Lanes) -> Lanes:
    """``lanes`` with its slot fields rebuilt for a streamed window, on
    the device and with no host read.

    ``perm`` sorts the slots by (lane, VM, ``rank_in_vm``), slots of no
    VM last.  Admission gives each VM's arrivals strictly increasing
    ranks, so there are no ties, and along each row of the sorted axis
    the kernel's running count of runnable slots is the FCFS rank the
    JAX engine counts pairwise.  The row index is padded
    (``padded_row_index``), and ``row_rounds`` is the bound the window
    size gives, not a read of the longest row."""
    b, c, v = lanes.n_lanes, lanes.n_cloudlets, lanes.n_vms
    dev = dc.time.device
    cl = dc.cloudlets
    vm = cl.vm.long()
    base = torch.arange(b, device=dev)[:, None] * v
    in_row = (vm >= 0) & (vm < v)
    slot_vm = (torch.clamp(vm, 0, max(v - 1, 0)) + base).reshape(-1)
    group = torch.where(in_row, vm + base, b * v).reshape(-1)
    key = group * (1 << 31) + torch.where(
        in_row, cl.rank_in_vm.long(), 0).reshape(-1)
    perm = torch.argsort(key, stable=True)
    row = group[perm]
    index = padded_row_index(
        torch.where(row < b * v, row, -1).to(torch.int32), b * v)
    pos = torch.arange(b * c, device=dev)
    first = index.start.long()[torch.clamp(row, max=max(b * v - 1, 0))]
    return dataclasses.replace(
        lanes, slot_vm=slot_vm, index=index, perm=perm,
        slot_rel=torch.where(row < b * v, pos - first, 0))


@dataclasses.dataclass
class HostPlan:
    """What changes only when VMs are placed (``provision_pending``).

    VMs with a host are sorted by (host, creation time, slot), and each
    host's VMs are one run of ``order``; VMs without one sort last.
    """
    vm_host: torch.Tensor       # i64[B*V] global host, clamped into its lane
    placed: torch.Tensor        # bool[B*V] the VM has a host
    order: torch.Tensor         # i64[B*V] the sort
    seg: torch.Tensor           # i64[B*V] host of each sorted VM (B*H: none)
    start: torch.Tensor         # i64[B*V] first sorted position of its run
    rel: torch.Tensor           # i64[B*V] sorted position - start
    rounds: int                 # run_scan rounds for the fullest host
    ends: torch.Tensor          # i64[R] last sorted position of each host
    end_host: torch.Tensor      # i64[R] that host
    demand: torch.Tensor        # f32[B*V] req_pes * min(req_mips, host MIPS)
    occupancy: torch.Tensor     # i32[B*H] ACTIVE VMs placed on each host
    pes: torch.Tensor           # i32[B*V] max(req_pes, 1)
    keeps_work: torch.Tensor    # bool[B*V] PEs reserved, or ACTIVE and
    #                             alone on its host: draining cannot flip
    #                             its host's level-1 split
    slot_host: torch.Tensor     # i64[B*C] host of each slot's VM, clamped
    slot_mips_pe: torch.Tensor  # f32[B*C] that host's MIPS per PE


def host_plan(dc: DatacenterState, lanes: Lanes) -> HostPlan:
    """``HostPlan`` of a batched state (two host syncs)."""
    vms, hosts = dc.vms, dc.hosts
    b, h = lanes.n_lanes, lanes.n_hosts
    dev = dc.time.device
    host = vms.host.long()
    base = torch.arange(b, device=dev)[:, None] * h
    vm_host = (torch.clamp(host, 0, max(h - 1, 0)) + base).reshape(-1)
    placed = (host >= 0).reshape(-1)
    key = torch.where(placed, vm_host, b * h)
    order = torch.argsort(vms.create_time.reshape(-1), stable=True)
    order = order[torch.argsort(key[order], stable=True)]
    seg = key[order]
    n = seg.shape[0]
    start = run_starts(seg).long()
    last = torch.ones(n, dtype=torch.bool, device=dev)
    last[:-1] = seg[1:] != seg[:-1]
    ends = torch.nonzero(last & (seg < b * h)).view(-1)
    longest = int((ends - start[ends] + 1).max()) if ends.numel() else 0
    flat = lambda t: t.reshape(-1)
    mips_pe = flat(hosts.mips_per_pe)
    active = (flat(vms.state) == VM_ACTIVE) & placed
    occupancy = torch.zeros((b * h,), dtype=torch.int32,
                            device=dev).index_add_(
        0, vm_host, active.to(torch.int32))
    slot_host = vm_host[lanes.slot_vm]
    alone = active & (occupancy[vm_host] == 1)
    return HostPlan(
        vm_host=vm_host, placed=placed, order=order, seg=seg, start=start,
        rel=torch.arange(n, device=dev) - start,
        rounds=rounds_for(longest), ends=ends, end_host=seg[ends],
        demand=(flat(vms.req_pes).to(torch.float32)
                * torch.minimum(flat(vms.req_mips), mips_pe[vm_host])),
        occupancy=occupancy,
        pes=torch.clamp(flat(vms.req_pes), min=1),
        keeps_work=lanes.reserve_rows | alone, slot_host=slot_host,
        slot_mips_pe=mips_pe[slot_host])


def refresh_slots(dc: DatacenterState, plan: HostPlan, lanes: Lanes
                  ) -> HostPlan:
    """``plan`` with its slot fields read again through ``lanes.slot_vm``
    (a streamed window's admissions move slots between VMs)."""
    slot_host = plan.vm_host[lanes.slot_vm]
    return dataclasses.replace(
        plan, slot_host=slot_host,
        slot_mips_pe=dc.hosts.mips_per_pe.reshape(-1)[slot_host])


def host_sums(per_vm: torch.Tensor, plan: HostPlan, n_hosts: int
              ) -> torch.Tensor:
    """[B*H] sum of ``per_vm`` ([B*V], in VM order) over each host's VMs,
    in the plan's fixed order (creation time, then slot)."""
    ran = run_scan(per_vm[plan.order], plan.rel, plan.rounds)
    return torch.zeros((n_hosts,), dtype=per_vm.dtype,
                       device=per_vm.device).index_put_(
        (plan.end_host,), ran[plan.ends])


def vm_sums(per_slot: torch.Tensor, lanes: Lanes) -> torch.Tensor:
    """[B*V] sum of ``per_slot`` ([B*C]) over each VM's slots, in a fixed
    order (a doubling scan along each row, ``segments.run_scan``), so a
    lane gives the same bits alone or in a batch."""
    if lanes.perm is not None:
        per_slot = per_slot[lanes.perm]
    ran = run_scan(per_slot, lanes.slot_rel, lanes.row_rounds)
    index = lanes.index
    last = torch.clamp(index.start.long() + index.length.long() - 1, min=0)
    if ran.shape[0] == 0:
        return torch.zeros(index.n_rows, dtype=per_slot.dtype,
                           device=per_slot.device)
    return torch.where(index.length > 0, ran[last], 0.0)


def host_consumed(rates: torch.Tensor, lanes: Lanes, plan: HostPlan
                  ) -> torch.Tensor:
    """f64[B*H] MIPS consumed on each host at cloudlet ``rates`` ([B*C]).

    Each VM's rates are summed in f64 (``index_add_``), then each host's
    VMs in the plan's fixed order.  Level 2 gives every running cloudlet
    of a VM the same rate r, so a VM's partial sums are multiples k * r,
    exact in f64 (k < 2^29) and the same in any order of the additions;
    the sum over a host's VMs, of unequal terms, is the one that needs
    the fixed order.  A host may carry hundreds of thousands of
    cloudlets (a skewed binding), whose f32 running sum would drift by
    1e-4 relative and more.
    """
    per_vm = torch.zeros((lanes.n_lanes * lanes.n_vms,),
                         dtype=torch.float64, device=rates.device)
    per_vm.index_add_(0, lanes.slot_vm, rates.to(torch.float64))
    return host_sums(per_vm, plan, lanes.n_lanes * lanes.n_hosts)


# ---------------------------------------------------------------------------
# The passes, on a batched state and its flat axes
# ---------------------------------------------------------------------------
def lane_runnable(dc: DatacenterState, lanes: Lanes, *,
                  networked: bool = False) -> torch.Tensor:
    """bool[B*C] — ``cloudlet_runnable`` of every lane."""
    cl, vms = dc.cloudlets, dc.vms
    owner = lanes.slot_vm
    vm_ok = vms.state.reshape(-1)[owner] == VM_ACTIVE
    not_migrating = vms.mig_remaining.reshape(-1)[owner] <= 0.0
    ok = ((cl.state == CL_CREATED)
          & (cl.submit_time <= dc.time[:, None])
          & (cl.remaining > 0.0)
          & (cl.vm >= 0))
    if networked:
        # an enabled lane's cloudlet draws CPU only once staged in
        ok &= (dc.net.enabled[:, None] != 1) | (cl.net_phase == NET_RUN)
    return ok.reshape(-1) & vm_ok & not_migrating


def run_counts(runnable: torch.Tensor, lanes: Lanes) -> torch.Tensor:
    """i32[B*V] runnable cloudlets of each VM."""
    return torch.zeros((lanes.n_lanes * lanes.n_vms,), dtype=torch.int32,
                       device=runnable.device).index_add_(
        0, lanes.slot_vm, runnable.to(torch.int32))


def _eligible(dc: DatacenterState, lanes: Lanes, counts: torch.Tensor
              ) -> torch.Tensor:
    """bool[B*V] — VMs competing for host capacity: reserve_pes=1 holds
    PEs for the VM's whole life (§5); else only VMs with work compete
    (Fig. 3).  ``counts`` is ``run_counts`` of the runnable mask."""
    active = dc.vms.state.reshape(-1) == VM_ACTIVE
    return active & (lanes.reserve_rows | (counts > 0))


def _level1(dc: DatacenterState, lanes: Lanes, plan: HostPlan,
            eligible: torch.Tensor) -> torch.Tensor:
    """f32[B*V] — ``host_level_shares`` of every lane."""
    hosts = dc.hosts
    nh = lanes.n_lanes * lanes.n_hosts
    eligible = eligible & plan.placed
    demand = plan.demand

    # SPACE_SHARED: FCFS prefix-sum of PE requests within each host
    pes_sorted = torch.where(eligible, dc.vms.req_pes.reshape(-1),
                             0)[plan.order].to(torch.int32)
    csum = torch.cumsum(pes_sorted, 0, dtype=torch.int32)
    cum_incl = csum - (csum - pes_sorted)[plan.start]
    fits_sorted = cum_incl <= hosts.num_pes.reshape(-1)[
        torch.clamp(plan.seg, max=max(nh - 1, 0))]
    fits = torch.zeros_like(eligible)
    fits[plan.order] = fits_sorted
    space_cap = torch.where(fits & eligible, demand, 0.0)

    # TIME_SHARED: proportional scale-down when oversubscribed
    total_demand = host_sums(torch.where(eligible, demand, 0.0), plan, nh)
    host_cap = (hosts.num_pes.to(torch.float32)
                * hosts.mips_per_pe).reshape(-1)
    scale = torch.where(
        total_demand > 0.0,
        torch.clamp(host_cap / torch.clamp(total_demand, min=1e-30),
                    max=1.0),
        0.0)
    time_cap = torch.where(eligible, demand * scale[plan.vm_host], 0.0)

    return torch.where(lanes.space_rows, space_cap, time_cap)


def _level2(dc: DatacenterState, lanes: Lanes, vm_capacity: torch.Tensor,
            runnable: torch.Tensor):
    """(rates f32[B*C], dt_min f32[B*V]) through the simstep kernel: one
    launch for every lane.  A streamed window is read through its
    regrouped view, and the rates are scattered back to the slots."""
    remaining = dc.cloudlets.remaining.reshape(-1)
    perm = lanes.perm
    if perm is not None:
        remaining, runnable = remaining[perm], runnable[perm]
    rates, dt_min = simstep_ragged(
        remaining, runnable, lanes.index, vm_capacity,
        dc.vms.req_pes.reshape(-1).to(torch.float32), lanes.row_policy)
    if perm is not None:
        rates = torch.empty_like(rates).index_copy_(0, perm, rates)
    return rates, dt_min


def lane_min(x: torch.Tensor) -> torch.Tensor:
    """[B] minimum over the last axis of [B, N] (INF when N is 0)."""
    if x.shape[-1] == 0:
        return torch.full(x.shape[:-1], INF, dtype=torch.float32,
                          device=x.device)
    return x.amin(dim=-1)


def lane_rates(dc: DatacenterState, lanes: Lanes, plan: HostPlan, *,
               networked: bool = False):
    """(rates f32[B, C], dt_finish f32[B], counts i32[B*V]) — the full
    two-level pass of every lane, each lane's earliest completion delta
    (INF when nothing runs) and each VM's runnable cloudlets."""
    runnable = lane_runnable(dc, lanes, networked=networked)
    counts = run_counts(runnable, lanes)
    vm_cap = _level1(dc, lanes, plan, _eligible(dc, lanes, counts))
    rates, dt_min = _level2(dc, lanes, vm_cap, runnable)
    return (rates.view(lanes.n_lanes, lanes.n_cloudlets),
            lane_min(dt_min.view(lanes.n_lanes, lanes.n_vms)), counts)


# ---------------------------------------------------------------------------
# One state (a batch of one lane)
# ---------------------------------------------------------------------------
def _one(dc: DatacenterState, streaming: bool = False):
    batch = lane_axis(dc)
    lanes = lanes_of(batch, streaming=streaming)
    return batch, lanes


def cloudlet_runnable(dc: DatacenterState, *,
                      networked: bool = False) -> torch.Tensor:
    """bool[C] — submitted, unfinished, and its VM is placed and running
    (and not mid-migration).  ``networked``: on an enabled topology the
    cloudlet must also be staged in (``net_phase == NET_RUN``)."""
    batch, lanes = _one(dc)
    return lane_runnable(batch, lanes, networked=networked)


def vm_has_work(dc: DatacenterState, runnable: torch.Tensor) -> torch.Tensor:
    """bool[V] — VM has at least one runnable cloudlet right now."""
    return run_counts(runnable, _one(dc)[1]) > 0


def host_level_shares(dc: DatacenterState, eligible: torch.Tensor
                      ) -> torch.Tensor:
    """f32[V] total MIPS granted to each VM by its host.

    SPACE_SHARED grants whole PEs in FCFS order of creation time with
    strict head-of-line blocking; TIME_SHARED scales every eligible VM's
    request down proportionally when its host is oversubscribed.
    """
    batch, lanes = _one(dc)
    return _level1(batch, lanes, host_plan(batch, lanes), eligible)


def vm_level_rates(dc: DatacenterState, vm_capacity: torch.Tensor,
                   runnable: torch.Tensor, *,
                   streaming: bool = False) -> torch.Tensor:
    """f32[C] MIPS given to each cloudlet from its VM's granted capacity.

    SPACE_SHARED: the first ``req_pes`` runnable cloudlets (by slot order;
    by ``rank_in_vm`` when ``streaming``, on a window of recycled slots)
    each get one virtual PE.  TIME_SHARED: capacity / max(n_runnable,
    req_pes).
    """
    batch, lanes = _one(dc, streaming)
    return _level2(batch, lanes, vm_capacity, runnable)[0]


def rates_and_dt(dc: DatacenterState, *, networked: bool = False,
                 streaming: bool = False):
    """(rates f32[C], dt_finish f32[]) — the full two-level pass and the
    earliest completion delta (INF when nothing runs)."""
    batch, lanes = _one(dc, streaming)
    rates, dt, _ = lane_rates(batch, lanes, host_plan(batch, lanes),
                              networked=networked)
    return rates[0], dt[0]


def cloudlet_rates(dc: DatacenterState, *, networked: bool = False,
                   streaming: bool = False) -> torch.Tensor:
    """f32[C] — execution rate (MIPS) of every cloudlet at ``dc.time``;
    ``streaming`` reads a window of recycled slots through its regrouped
    view (FCFS by ``rank_in_vm``)."""
    return rates_and_dt(dc, networked=networked, streaming=streaming)[0]
