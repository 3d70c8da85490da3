"""Two-level VM/cloudlet scheduling (``repro.core.scheduling`` in PyTorch).

Level 1 (host -> VM, the VMScheduler) grants each VM a share of its
host's MIPS; level 2 (VM -> cloudlet, the CloudletScheduler) divides the
VM's share among its task units.  Each level is SPACE_SHARED or
TIME_SHARED, the 2x2 matrix of the paper's Figure 3.

Level 2 runs through the ``simstep`` kernel, which reads the flat
grouped-by-VM cloudlet axis directly through a ``RowIndex`` (each VM's
slots are one contiguous run) and computes every cloudlet's rate and each
VM's earliest completion: O(C + V), as the JAX package's grouped-segment
pass.
"""
from __future__ import annotations

import torch

from repro_torch.core.segments import segment_cumsum
from repro_torch.core.state import (CL_CREATED, INF, SPACE_SHARED, VM_ACTIVE,
                                    DatacenterState)
from repro_torch.kernels.simstep.ops import (RowIndex, row_index,
                                             simstep_ragged)

__all__ = ["cloudlet_runnable", "vm_has_work", "host_level_shares",
           "vm_level_rates", "cloudlet_rates"]


def cloudlet_runnable(dc: DatacenterState) -> torch.Tensor:
    """bool[C] — submitted, unfinished, and its VM is placed and running
    (and not mid-migration)."""
    cl = dc.cloudlets
    owner = torch.clamp(cl.vm, min=0).long()
    vm_ok = dc.vms.state[owner] == VM_ACTIVE
    not_migrating = dc.vms.mig_remaining[owner] <= 0.0
    return ((cl.state == CL_CREATED)
            & (cl.submit_time <= dc.time)
            & (cl.remaining > 0.0)
            & (cl.vm >= 0)
            & vm_ok
            & not_migrating)


def vm_has_work(dc: DatacenterState, runnable: torch.Tensor) -> torch.Tensor:
    """bool[V] — VM has at least one runnable cloudlet right now."""
    nvm = dc.vms.req_pes.shape[0]
    seg = torch.clamp(dc.cloudlets.vm, 0, nvm - 1).long()
    counts = torch.zeros((nvm,), dtype=torch.int32,
                         device=runnable.device).index_add_(
        0, seg, runnable.to(torch.int32))
    return counts > 0


def _host_order(host_idx: torch.Tensor, create_time: torch.Tensor
                ) -> torch.Tensor:
    """Permutation sorting VMs by (host, create_time, slot) — chained
    stable sorts, least significant key first."""
    order = torch.argsort(create_time, stable=True)
    return order[torch.argsort(host_idx[order], stable=True)]


def host_level_shares(dc: DatacenterState, eligible: torch.Tensor
                      ) -> torch.Tensor:
    """f32[V] total MIPS granted to each VM by its host.

    SPACE_SHARED grants whole PEs in FCFS order of creation time with
    strict head-of-line blocking; TIME_SHARED scales every eligible VM's
    request down proportionally when its host is oversubscribed.
    """
    vms, hosts = dc.vms, dc.hosts
    nh = hosts.num_pes.shape[0]
    dev = eligible.device

    eligible = eligible & (vms.host >= 0)
    host_idx = torch.clamp(vms.host, 0, nh - 1).long()

    host_mips_pe = hosts.mips_per_pe[host_idx]
    eff_mips_pe = torch.minimum(vms.req_mips, host_mips_pe)
    demand = vms.req_pes.to(torch.float32) * eff_mips_pe

    # SPACE_SHARED: FCFS prefix-sum of PE requests within each host
    order = _host_order(host_idx, vms.create_time)
    pes_sorted = torch.where(eligible, vms.req_pes, 0)[order].to(torch.int32)
    host_sorted = host_idx[order]
    cum_incl = segment_cumsum(pes_sorted, host_sorted, exclusive=False)
    fits_sorted = cum_incl <= hosts.num_pes[host_sorted]
    fits = torch.zeros_like(eligible)
    fits[order] = fits_sorted
    space_cap = torch.where(fits & eligible, demand, 0.0)

    # TIME_SHARED: proportional scale-down when oversubscribed
    seg = torch.where(eligible, host_idx, nh)
    total_demand = torch.zeros((nh + 1,), dtype=torch.float32,
                               device=dev).index_add_(
        0, seg, torch.where(eligible, demand, 0.0))[:nh]
    host_cap = hosts.num_pes.to(torch.float32) * hosts.mips_per_pe
    scale = torch.where(
        total_demand > 0.0,
        torch.clamp(host_cap / torch.clamp(total_demand, min=1e-30),
                    max=1.0),
        0.0)
    time_cap = torch.where(eligible, demand * scale[host_idx], 0.0)

    return torch.where(dc.vm_policy == SPACE_SHARED, space_cap, time_cap)


def _level2(dc: DatacenterState, vm_capacity: torch.Tensor,
            runnable: torch.Tensor, index: RowIndex):
    """(rates f32[C], dt_min f32[V]) through the simstep kernel."""
    return simstep_ragged(dc.cloudlets.remaining, runnable, index,
                          vm_capacity, dc.vms.req_pes.to(torch.float32),
                          dc.task_policy)


def vm_level_rates(dc: DatacenterState, vm_capacity: torch.Tensor,
                   runnable: torch.Tensor) -> torch.Tensor:
    """f32[C] MIPS given to each cloudlet from its VM's granted capacity.

    SPACE_SHARED: the first ``req_pes`` runnable cloudlets (by slot order)
    each get one virtual PE.  TIME_SHARED: capacity / max(n_runnable,
    req_pes).
    """
    index = row_index(dc.cloudlets.vm, dc.vms.req_pes.shape[0])
    return _level2(dc, vm_capacity, runnable, index)[0]


def _eligible(dc: DatacenterState, runnable: torch.Tensor) -> torch.Tensor:
    # reserve_pes=1: PEs are held for the VM's whole life (§5); else only
    # VMs with work compete (Fig. 3)
    active = dc.vms.state == VM_ACTIVE
    return torch.where(dc.reserve_pes == 1, active,
                       active & vm_has_work(dc, runnable))


def rates_and_dt(dc: DatacenterState, index: RowIndex):
    """(rates f32[C], dt_finish f32[]) — the full two-level pass and the
    earliest completion delta (INF when nothing runs).  ``index`` is
    ``row_index(dc.cloudlets.vm, V)``, built once per run."""
    runnable = cloudlet_runnable(dc)
    vm_cap = host_level_shares(dc, _eligible(dc, runnable))
    rates, dt_min = _level2(dc, vm_cap, runnable, index)
    if dt_min.numel() == 0:
        return rates, torch.full((), INF, dtype=torch.float32,
                                 device=rates.device)
    return rates, dt_min.amin()


def cloudlet_rates(dc: DatacenterState) -> torch.Tensor:
    """f32[C] — execution rate (MIPS) of every cloudlet at ``dc.time``."""
    index = row_index(dc.cloudlets.vm, dc.vms.req_pes.shape[0])
    return rates_and_dt(dc, index)[0]
