"""Plain PyTorch version of the simstep kernel (``repro.kernels.simstep.ref``).

Dense [V, K] cloudlet layout: V VM rows, K cloudlet slots per row in
submission order.  Given each VM's granted capacity, produce

  rates  f32[V, K]  MIPS per cloudlet under the VM-level policy
  dt_min f32[V]     earliest completion among the row's running cloudlets

— ``scheduling.vm_level_rates`` plus the per-VM event-time min, restated
on the dense layout.  The CPU path of ``ops.simstep`` and the yardstick
the CUDA kernel is held against.
"""
from __future__ import annotations

import torch

INF = 1e30
SPACE_SHARED = 0
TIME_SHARED = 1


def simstep_ref(remaining: torch.Tensor, runnable: torch.Tensor,
                vm_capacity: torch.Tensor, req_pes: torch.Tensor,
                task_policy):
    """remaining f32[V,K]; runnable bool[V,K]; vm_capacity f32[V];
    req_pes f32[V]; policy scalar.  Returns (rates [V,K], dt_min [V])."""
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
    rates = torch.where(policy == SPACE_SHARED,
                        space, time)
    rates = torch.where(runnable, rates, 0.0)

    dt = torch.where(rates > 0.0,
                     remaining / torch.clamp(rates, min=1e-30), INF)
    if dt.shape[1] == 0:
        return rates, torch.full(dt.shape[:1], INF, dtype=torch.float32,
                                 device=dt.device)
    return rates, dt.amin(dim=1)
