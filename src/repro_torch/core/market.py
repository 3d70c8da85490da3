"""Cloud market modeling, §3.3 (``repro.core.market`` in PyTorch).

Memory and storage bill at VM creation (provisioning), CPU per PE-second
consumed and bandwidth per MB transferred (engine).  This module holds
the quotes, the per-VM bill and the surge pricing of revenue sweeps.
The spot-price functions come with the elastic slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import state as S

__all__ = ["quote_vm", "quote_cloudlet", "bill_by_vm", "flat_rates",
           "PricingPolicy", "tiered_cpu_rates"]


def quote_vm(rates: S.MarketRates, *, ram: float, size: float
             ) -> torch.Tensor:
    """Up-front cost of creating one VM (memory + storage)."""
    return rates.cost_per_mem * ram + rates.cost_per_storage * size


def quote_cloudlet(rates: S.MarketRates, *, length_mi: float,
                   host_mips_pe: float, file_size: float = 0.0,
                   output_size: float = 0.0) -> torch.Tensor:
    """Expected cost of one task unit on a given host class: CPU per
    PE-second (L/M seconds whatever the sharing) plus its transfers."""
    mips = torch.as_tensor(host_mips_pe, dtype=torch.float32,
                           device=rates.cost_per_cpu_sec.device)
    pe_seconds = length_mi / torch.clamp(mips, min=1e-30)
    return (rates.cost_per_cpu_sec * pe_seconds
            + rates.cost_per_bw * (file_size + output_size))


def bill_by_vm(dc: S.DatacenterState) -> torch.Tensor:
    """f32[V] — bill attribution per VM from a final state: executed MI
    over host MIPS at the CPU rate, finished transfer volumes at the BW
    rate, and creation charges of every VM that was placed."""
    cl, vms = dc.cloudlets, dc.vms
    nv = vms.req_pes.shape[0]
    nh = dc.hosts.num_pes.shape[0]
    seg = torch.clamp(cl.vm, 0, nv - 1).long()
    seg_sum = lambda x: torch.zeros((nv,), dtype=torch.float32,
                                    device=x.device).index_add_(0, seg, x)

    executed = cl.length - cl.remaining
    host_of_cl = vms.host[seg]
    mips = dc.hosts.mips_per_pe[torch.clamp(host_of_cl, 0, nh - 1).long()]
    pe_sec = torch.where(host_of_cl >= 0,
                         executed / torch.clamp(mips, min=1e-30), 0.0)
    cpu = seg_sum(pe_sec) * dc.rates.cost_per_cpu_sec

    done = cl.state == S.CL_DONE
    moved = torch.where(done, cl.file_size + cl.output_size, 0.0)
    bw = seg_sum(moved) * dc.rates.cost_per_bw

    placed = (vms.state == S.VM_ACTIVE) | (vms.state == S.VM_DESTROYED)
    create = torch.where(placed,
                         dc.rates.cost_per_mem * vms.ram
                         + dc.rates.cost_per_storage * vms.size, 0.0)
    return cpu + bw + create


def flat_rates(cpu=0.01, mem=0.001, storage=0.0001, bw=0.002, *,
               device=None) -> S.MarketRates:
    return S.make_market(cpu, mem, storage, bw, device=device)


class PricingPolicy(NamedTuple):
    """Provider-side pricing knobs for revenue sweeps (beyond the paper)."""
    base: S.MarketRates
    surge_threshold: torch.Tensor   # utilization above which CPU surges
    surge_factor: torch.Tensor


def tiered_cpu_rates(policy: PricingPolicy, utilization) -> S.MarketRates:
    """Surge pricing: the CPU rate scales when the datacenter runs hot."""
    base = policy.base.cost_per_cpu_sec
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                     device=base.device)
    surge = torch.where(as_t(utilization) > as_t(policy.surge_threshold),
                        as_t(policy.surge_factor), 1.0)
    return dataclasses.replace(policy.base, cost_per_cpu_sec=base * surge)
