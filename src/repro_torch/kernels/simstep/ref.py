"""Plain PyTorch versions of the simstep kernel
(``repro.kernels.simstep.ref``).

Given each VM's granted capacity, produce

  rates  MIPS per cloudlet under the VM-level policy
  dt_min f32[V]  earliest completion among each VM's running cloudlets

— ``scheduling.vm_level_rates`` plus the per-VM event-time min.
``simstep_ref`` states it on the dense [V, K] layout of the JAX reference
(V VM rows, K cloudlet slots per row in submission order);
``simstep_ragged_ref`` on the flat, ragged, grouped-by-VM cloudlet axis
described by a ``RowIndex``.  The CPU paths of ``ops.simstep`` and
``ops.simstep_ragged``, and the yardsticks the CUDA kernel is held
against.
"""
from __future__ import annotations

import torch

from repro_torch.core.segments import segment_cumsum

INF = 1e30
SPACE_SHARED = 0
TIME_SHARED = 1


def simstep_ref(remaining: torch.Tensor, runnable: torch.Tensor,
                vm_capacity: torch.Tensor, req_pes: torch.Tensor,
                task_policy):
    """remaining f32[V,K]; runnable bool[V,K]; vm_capacity f32[V];
    req_pes f32[V]; policy a scalar or i32[V] (one a row).  Returns
    (rates [V,K], dt_min [V])."""
    runnable = runnable & (remaining > 0.0)
    pes = torch.clamp(req_pes, min=1.0)[:, None]           # [V,1]
    cap = vm_capacity[:, None]                             # [V,1]
    per_pe = cap / pes

    # FCFS rank among runnable slots within the row
    rank = torch.cumsum(runnable.to(torch.int32), dim=1,
                        dtype=torch.int32) - 1
    space = torch.where(rank < pes.to(torch.int32), per_pe, 0.0)

    n_run = runnable.sum(dim=1, keepdim=True).to(torch.float32)
    time = cap / torch.maximum(n_run, pes)

    policy = torch.as_tensor(task_policy, device=remaining.device)
    if policy.ndim == 1:
        policy = policy[:, None]
    rates = torch.where(policy == SPACE_SHARED, space, time)
    rates = torch.where(runnable, rates, 0.0)

    dt = torch.where(rates > 0.0,
                     remaining / torch.clamp(rates, min=1e-30), INF)
    if dt.shape[1] == 0:
        return rates, torch.full(dt.shape[:1], INF, dtype=torch.float32,
                                 device=dt.device)
    return rates, dt.amin(dim=1)


def simstep_ragged_ref(remaining: torch.Tensor, runnable: torch.Tensor,
                       index, vm_capacity: torch.Tensor,
                       req_pes: torch.Tensor, task_policy):
    """remaining f32[C]; runnable bool[C]; ``index`` the ``RowIndex`` of
    the slots' VM ids; vm_capacity f32[V]; req_pes f32[V]; policy a scalar
    or i32[V] (one a row).
    Returns (rates f32[C], dt_min f32[V]).  A slot with no row gets rate
    0, a row with no slot dt_min 1e30.  On uniform rows it equals
    ``simstep_ref`` bit for bit."""
    row = index.slot_row
    placed = row >= 0
    nv = vm_capacity.shape[0]
    if nv == 0:
        return (torch.zeros_like(remaining),
                torch.empty((0,), dtype=torch.float32,
                            device=remaining.device))
    owner = torch.clamp(row, min=0).long()
    runnable = runnable & (remaining > 0.0) & placed
    run_i = runnable.to(torch.int32)
    pes = torch.clamp(req_pes, min=1.0)
    per_pe = (vm_capacity / pes)[owner]

    # FCFS rank among runnable slots within the row
    rank = segment_cumsum(run_i, row, exclusive=True)
    space = torch.where(rank < pes.to(torch.int32)[owner], per_pe, 0.0)

    n_run = torch.zeros((nv,), dtype=torch.int32,
                        device=remaining.device).index_add_(0, owner, run_i)
    time = (vm_capacity / torch.maximum(n_run.to(torch.float32),
                                        pes))[owner]

    policy = torch.as_tensor(task_policy, device=remaining.device)
    if policy.ndim == 1:
        policy = policy[owner]
    rates = torch.where(policy == SPACE_SHARED, space, time)
    rates = torch.where(runnable, rates, 0.0)

    dt = torch.where(rates > 0.0,
                     remaining / torch.clamp(rates, min=1e-30), INF)
    dt_min = torch.full((nv,), INF, dtype=torch.float32,
                        device=remaining.device).scatter_reduce(
        0, owner, dt, reduce="amin")
    return rates, dt_min
