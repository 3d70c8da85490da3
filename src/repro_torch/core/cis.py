"""Cloud Information Service (``repro.core.cis`` in PyTorch): the
registry and match-making of §4.2, Figure 5.

Every datacenter registers one descriptor row; a broker queries the
registry for the providers whose offer matches a request and deploys
with the cheapest match.  A row is dense, so rows of D datacenters
stack into a table with leaves [D] (``stack``), and ``register`` of a
batched state gives the same table as its lanes' rows stacked.

The capacity columns are sums over a park's hosts.  They run past 2^24
at §5 scale (40,000 hosts of 2 TB storage sum to 8e10 MB), where the
order of f32 additions shows, so they are summed in the port's fixed
order (``segments.pairwise_sum``): the card gives the CPU's bits, and a
lane of a batch its single row's.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core import state as S
from repro_torch.core.segments import pairwise_sum

__all__ = ["CisEntry", "register", "stack", "match", "rank_by_cost"]


class CisEntry(NamedTuple):
    """One registry row a datacenter (leaves [] for one row, [D] for a
    table)."""
    total_pes: torch.Tensor        # f32
    max_mips_pe: torch.Tensor      # f32
    free_ram: torch.Tensor         # f32, MB
    free_storage: torch.Tensor     # f32, MB
    free_bw: torch.Tensor          # f32
    free_pes: torch.Tensor         # f32
    cost_per_cpu_sec: torch.Tensor
    cost_per_mem: torch.Tensor


def register(dc: S.DatacenterState) -> CisEntry:
    """Datacenter -> registry row (the §4.2 'register' arrow).  Leading
    lane axes pass through."""
    h = dc.hosts
    v = h.valid
    f = lambda x: pairwise_sum(torch.where(v, x, 0.0))
    return CisEntry(
        total_pes=f(h.num_pes.to(torch.float32)),
        max_mips_pe=torch.where(v, h.mips_per_pe, 0.0).amax(dim=-1),
        free_ram=f(h.free_ram),
        free_storage=f(h.free_storage),
        free_bw=f(h.free_bw),
        free_pes=f(h.free_pes),
        cost_per_cpu_sec=dc.rates.cost_per_cpu_sec,
        cost_per_mem=dc.rates.cost_per_mem,
    )


def stack(rows: Sequence[CisEntry]) -> CisEntry:
    """Registry rows -> one table, leaves [D] (the federation's gather)."""
    return CisEntry(*(torch.stack(col) for col in zip(*rows)))


def match(table: CisEntry, *, need_pes: float, need_mips: float,
          need_ram: float, need_storage: float, need_bw: float = 0.0
          ) -> torch.Tensor:
    """bool[D] — datacenters able to host the request."""
    return ((table.free_pes >= need_pes)
            & (table.max_mips_pe >= need_mips)
            & (table.free_ram >= need_ram)
            & (table.free_storage >= need_storage)
            & (table.free_bw >= need_bw))


def rank_by_cost(table: CisEntry, feasible: torch.Tensor) -> torch.Tensor:
    """i32[D] — feasible datacenters cheapest first, infeasible last;
    equal prices keep their row order (a stable sort)."""
    score = torch.where(feasible, table.cost_per_cpu_sec, 1e30)
    return torch.argsort(score, stable=True).to(torch.int32)
