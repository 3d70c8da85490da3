"""VM provisioning (``repro.core.provisioning`` in PyTorch).

CloudSim's ``VMProvisioner``: each pending VM goes to a host that passes
the RAM/BW/storage/PE admission chain, chosen by one of five policies:

  * FIRST_FIT   — the paper's default (sequential host order),
  * BEST_FIT    — feasible host with the least free RAM,
  * WORST_FIT   — feasible host with the most free RAM,
  * ROUND_ROBIN — first-fit starting after the previously chosen host,
  * MOST_FULL   — feasible host with the highest RAM fraction in use.

Placement is sequential under FCFS: earlier VMs consume capacity seen by
later ones.  The JAX package scans every VM slot and makes the iterations
of VMs that are not due identities; here only the due VMs are placed, in
(submit_time, slot) order — the same sequence of updates.  The free
pools live in one [P, H] tensor.  FIRST_FIT places a run of identical
requests at once (``_first_fit``); the other policies loop over the VMs
with the choices kept on the device, a handful of launches per VM.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.state import (CL_CREATED, CL_FAILED, VM_ACTIVE,
                                    VM_FAILED, VM_PENDING, DatacenterState)
from repro_torch.spans import count, span

FIRST_FIT = 0
BEST_FIT = 1
WORST_FIT = 2
ROUND_ROBIN = 3
MOST_FULL = 4

__all__ = ["FIRST_FIT", "BEST_FIT", "WORST_FIT", "ROUND_ROBIN",
           "MOST_FULL", "provision_pending", "pending_due",
           "feasible_hosts", "alive_mask", "alive_fleet"]

_BIG = 1e30


def alive_mask(vms) -> torch.Tensor:
    """bool[..., V] — PENDING or ACTIVE VM slots (fleet members)."""
    return (vms.state == VM_PENDING) | (vms.state == VM_ACTIVE)


def alive_fleet(vms) -> torch.Tensor:
    """i32[...] — alive (PENDING | ACTIVE) VM count."""
    return alive_mask(vms).sum(dim=-1, dtype=torch.int32)


def pending_due(dc: DatacenterState) -> torch.Tensor:
    """bool[...] — some VM is pending and its submit time has come (per
    lane of a batched state)."""
    return ((dc.vms.state == VM_PENDING)
            & (dc.vms.submit_time <= dc.time[..., None])).any(dim=-1)


def _static_ok(dc: DatacenterState, req_pes, req_mips, reserve: bool
               ) -> torch.Tensor:
    """bool[H] — the admission checks that no placement changes."""
    hosts = dc.hosts
    ok = hosts.valid & (hosts.mips_per_pe >= req_mips)
    return ok if reserve else ok & (hosts.num_pes >= req_pes)


def _pools(free_ram, free_bw, free_storage, free_pes, reserve: bool
           ) -> torch.Tensor:
    """f32[P, ...] free RAM, BW and storage (and PEs when reserved)."""
    return torch.stack([free_ram, free_bw, free_storage,
                        free_pes][:3 + reserve])


def _needs(ram, bw, size, req_pes, reserve: bool) -> torch.Tensor:
    """f32[P, ...] what a VM takes from the pools of ``_pools``."""
    return _pools(ram, bw, size, req_pes.to(torch.float32), reserve)


def _feasible(pools, need, static_ok) -> torch.Tensor:
    return (pools >= need[:, None]).all(dim=0) & static_ok


def feasible_hosts(dc: DatacenterState, free_ram, free_bw, free_storage,
                   free_pes, *, ram, bw, size, req_pes, req_mips
                   ) -> torch.Tensor:
    """bool[..., H] — hosts able to admit a VM with the given
    requirements (one state, or a batch of lanes with each lane's
    requirements as [B, 1]).

    The paper's admission chain: RAM, bandwidth, storage, per-PE MIPS
    and PEs.  Under ``reserve_pes`` PEs are held exclusively, so
    unreserved PEs are needed; otherwise the host must merely have
    enough PEs.
    """
    hosts = dc.hosts
    reserve = dc.reserve_pes
    if reserve.ndim:
        reserve = reserve[..., None]
    pes_ok = torch.where(reserve == 1,
                         free_pes >= torch.as_tensor(req_pes).to(
                             torch.float32),
                         hosts.num_pes >= req_pes)
    return (hosts.valid & (free_ram >= ram) & (free_bw >= bw)
            & (free_storage >= size) & (hosts.mips_per_pe >= req_mips)
            & pes_ok)


def _pick(feas, free_ram, total_ram, policy: int, rr_cursor, idx
          ) -> torch.Tensor:
    """i64[...] — the host ``policy`` picks over the last axis, whether
    or not any is feasible."""
    nh = feas.shape[-1]
    if policy == BEST_FIT:
        return torch.argmin(torch.where(feas, free_ram, _BIG), dim=-1)
    if policy == WORST_FIT:
        return torch.argmax(torch.where(feas, free_ram, -_BIG), dim=-1)
    if policy == ROUND_ROBIN:
        after = torch.where(feas & (idx >= rr_cursor), idx, nh).amin(-1)
        return torch.where(after < nh, after,
                           torch.where(feas, idx, nh).amin(-1))
    if policy == MOST_FULL:
        frac_used = 1.0 - free_ram / torch.clamp(total_ram, min=1e-30)
        return torch.argmax(torch.where(feas, frac_used, -_BIG), dim=-1)
    raise ValueError(f"unknown provisioning policy {policy}")


def _choose(feas, free_ram, total_ram, policy: int, rr_cursor, idx
            ) -> torch.Tensor:
    """i64[...] — host chosen over the last axis by a policy other than
    FIRST_FIT, or H when no host is feasible.  Ties go to the lowest
    index, as ``argmax`` and ``argmin`` give them.
    """
    pick = _pick(feas, free_ram, total_ram, policy, rr_cursor, idx)
    return torch.where(feas.any(dim=-1), pick, feas.shape[-1])


def _accrue(total: torch.Tensor, terms: torch.Tensor, ok: np.ndarray):
    """``total`` plus each placed VM's f32 term, added one at a time in
    placement order (the JAX scan's f32 rounding, done on the host)."""
    with span("sync.provision.total"):
        acc = np.float32(total.item())
    with span("sync.provision.terms"):
        host_terms = terms.cpu().numpy()
    for t in host_terms[ok]:
        acc = np.float32(acc + t)
    with span("sync.provision.upload"):
        return torch.tensor(acc, dtype=torch.float32, device=total.device)


def _one_by_one(pools, needs, static_ok, total_ram, policy: int
                ) -> torch.Tensor:
    """Place the due VMs in order, one at a time; ``pools`` is updated in
    place.  Returns each VM's host (H when it failed)."""
    nh = pools.shape[1]
    idx = torch.arange(nh, device=pools.device)
    takes = -needs
    rr_cursor = torch.zeros((), dtype=torch.long, device=pools.device)
    chosen = torch.empty(needs.shape[1:], dtype=torch.long,
                         device=pools.device)
    for i in range(needs.shape[1]):
        feas = _feasible(pools, needs[:, i], static_ok(i))
        h = _choose(feas, pools[0], total_ram, policy, rr_cursor, idx)
        chosen[i] = h
        ok = h < nh
        hc = torch.clamp(h, max=nh - 1)
        pools.index_add_(1, hc.view(1),
                         torch.where(ok, takes[:, i], 0.0)[:, None])
        if policy == ROUND_ROBIN:
            rr_cursor = torch.where(ok, (hc + 1) % nh, rr_cursor)
    return chosen


def _first_fit(pools, needs, keys, static_ok):
    """FIRST_FIT placement of the due VMs, a run of identical requests at
    a time.  Returns (pools, each VM's host, H when it failed).

    Under first fit a run of identical requests fills hosts in index
    order: a placement shrinks only the chosen host's pools, so the
    hosts before it stay infeasible and the next VM goes to the same
    host or a later one.  Each host takes as many VMs as successive f32
    subtractions of the request leave it feasible for — computed for
    all hosts at once, one round per VM a host can hold — and the first
    hosts take the run.  The pools then get each host's subtractions one
    by one, as the sequential scan makes them: bitwise the same result
    as placing the VMs one at a time.
    """
    nh = pools.shape[1]
    n = needs.shape[1]
    chosen = torch.empty((n,), dtype=torch.long, device=pools.device)
    starts = np.flatnonzero(np.r_[True, np.any(keys[1:] != keys[:-1],
                                               axis=1)])
    for i, j in zip(starts, np.r_[starts[1:], n]):
        need = needs[:, i, None]
        static = static_ok(i)
        free = pools
        holds = torch.zeros((nh,), dtype=torch.long, device=pools.device)
        for _ in range(j - i):
            fits = _feasible(free, need[:, 0], static)
            with span("sync.provision.fits"):
                any_fits = bool(fits.any())
            if not any_fits:
                break
            free = torch.where(fits, free - need, free)
            holds += fits
        before = torch.cumsum(holds, 0) - holds
        takes = torch.clamp(torch.minimum(holds, (j - i) - before), min=0)
        chosen[i:j] = torch.searchsorted(
            before + holds, torch.arange(j - i, device=pools.device),
            right=True)
        with span("sync.provision.takes"):
            rounds = int(takes.max())
        for r in range(rounds):
            pools = torch.where(takes > r, pools - need, pools)
    return pools, chosen


def provision_pending(dc: DatacenterState, policy: int = FIRST_FIT
                      ) -> DatacenterState:
    """Place every VM pending at ``dc.time`` (FCFS by submit time, then
    slot).

    Unplaceable VMs become VM_FAILED and their cloudlets CL_FAILED;
    memory and storage costs accrue at creation (§3.3).  With no VM due
    this is the identity.
    """
    vms, hosts = dc.vms, dc.hosts
    nh = hosts.num_pes.shape[0]
    nv = vms.req_pes.shape[0]
    due = (vms.state == VM_PENDING) & (vms.submit_time <= dc.time)
    with span("sync.provision.due"):
        due_idx = torch.nonzero(due).view(-1)
    if due_idx.numel() == 0:
        return dc
    count("provision.vms", due_idx.numel())
    # FCFS: submit time, then slot (due_idx is ascending, the sort stable)
    order = due_idx[torch.argsort(vms.submit_time[due_idx], stable=True)]
    with span("sync.provision.reserve"):
        reserve = bool(dc.reserve_pes == 1)

    pools = _pools(hosts.free_ram, hosts.free_bw, hosts.free_storage,
                   hosts.free_pes, reserve)
    needs = _needs(vms.ram, vms.bw, vms.size, vms.req_pes, reserve)[:, order]
    # a VM's request: what it takes from the pools plus its static checks
    keys = torch.cat([needs, vms.req_mips[order][None],
                      vms.req_pes[order][None].to(torch.float32)]).T.double()
    with span("sync.provision.keys"):
        keys = keys.cpu().numpy()
    static = {}

    def static_ok(i):
        key = tuple(keys[i])
        if key not in static:
            v = order[i]
            with span("sync.provision.req_pes"):
                req_pes = vms.req_pes[v]
            with span("sync.provision.req_mips"):
                req_mips = vms.req_mips[v]
            static[key] = _static_ok(dc, req_pes, req_mips, reserve)
        return static[key]

    if policy == FIRST_FIT:
        pools, chosen = _first_fit(pools, needs, keys, static_ok)
    else:
        chosen = _one_by_one(pools, needs, static_ok, hosts.ram, policy)
    ok = chosen < nh
    host = vms.host.clone()
    state = vms.state.clone()
    create = vms.create_time.clone()
    host[order] = torch.where(ok, chosen, host[order].long()).to(torch.int32)
    state[order] = torch.where(ok, VM_ACTIVE, VM_FAILED).to(torch.int32)
    create[order] = torch.where(ok, dc.time, create[order])
    with span("sync.provision.ok"):
        ok_np = ok.cpu().numpy()
    mem_cost = _accrue(dc.acct.mem_cost,
                       dc.rates.cost_per_mem * vms.ram[order], ok_np)
    sto_cost = _accrue(dc.acct.storage_cost,
                       dc.rates.cost_per_storage * vms.size[order], ok_np)

    # cloudlets whose VM failed can never run
    cl = dc.cloudlets
    vm_failed = state[torch.clamp(cl.vm, 0, nv - 1).long()] == VM_FAILED
    cl_state = torch.where((cl.state == CL_CREATED) & vm_failed,
                           CL_FAILED, cl.state)
    return dataclasses.replace(
        dc,
        hosts=dataclasses.replace(
            hosts, free_ram=pools[0], free_bw=pools[1],
            free_storage=pools[2],
            free_pes=pools[3] if reserve else hosts.free_pes),
        vms=dataclasses.replace(vms, host=host, state=state,
                                create_time=create),
        cloudlets=dataclasses.replace(cl, state=cl_state),
        acct=dataclasses.replace(dc.acct, mem_cost=mem_cost,
                                 storage_cost=sto_cost))
