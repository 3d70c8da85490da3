"""DatacenterBroker (``repro.core.broker`` in PyTorch): builds VM fleets and
cloudlet waves from user specs, and reduces a final state into the report
the user gets back (§4.2)."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import state as S

__all__ = ["VmSpec", "WaveSpec", "build_fleet", "build_waves",
           "BrokerReport", "collect"]


@dataclasses.dataclass(frozen=True)
class VmSpec:
    """User request for one VM class (the §5 experiment: 1 PE, 512MB, 1GB)."""
    count: int
    pes: int = 1
    mips: float = 1000.0
    ram: float = 512.0
    bw: float = 10.0
    size: float = 1000.0
    submit_time: float = 0.0


@dataclasses.dataclass(frozen=True)
class WaveSpec:
    """Cloudlet waves: ``waves`` groups of one cloudlet per VM, ``period``
    apart."""
    waves: int
    length_mi: float = 1_200_000.0
    period: float = 600.0
    first_at: float = 0.0
    file_size: float = 0.3
    output_size: float = 0.3


def build_fleet(specs: Sequence[VmSpec], *, device=None) -> S.VmState:
    """Concatenate VM classes into one VmState (submission order)."""
    col = lambda attr: np.concatenate(
        [np.full(sp.count, getattr(sp, attr)) for sp in specs]) \
        if specs else np.zeros(0)
    return S.make_vms(col("pes"), col("mips"), col("ram"), col("bw"),
                      col("size"), col("submit_time"), device=device)


def build_waves(n_vms: int, spec: WaveSpec, *, device=None
                ) -> S.CloudletState:
    """§5 workload: every ``period`` seconds one cloudlet to each VM,
    grouped by VM with ranks ascending in wave order (FCFS per VM)."""
    vm_ids = np.repeat(np.arange(n_vms, dtype=np.int32), spec.waves)
    waves = np.tile(np.arange(spec.waves, dtype=np.float32), n_vms)
    submit = spec.first_at + waves * spec.period
    return S.make_cloudlets(vm_ids, spec.length_mi, submit, spec.file_size,
                            spec.output_size, device=device)


class BrokerReport(NamedTuple):
    """What the broker hands back to the user after collection."""
    n_submitted: torch.Tensor
    n_completed: torch.Tensor
    n_failed: torch.Tensor
    makespan: torch.Tensor         # last finish over completed cloudlets
    mean_response: torch.Tensor    # finish - submit
    p99_response: torch.Tensor
    mean_exec: torch.Tensor        # finish - start
    total_cost: torch.Tensor       # §3.3 market total
    cpu_cost: torch.Tensor
    mem_cost: torch.Tensor
    storage_cost: torch.Tensor
    bw_cost: torch.Tensor


def collect(dc: S.DatacenterState) -> BrokerReport:
    """Reduce a final datacenter state into the user-facing report."""
    cl = dc.cloudlets
    done = cl.state == S.CL_DONE
    nan = float("nan")
    resp = torch.where(done, cl.finish_time - cl.submit_time, nan)
    exe = torch.where(done, cl.finish_time - cl.start_time, nan)
    count = lambda m: m.sum(dtype=torch.int32)
    return BrokerReport(
        n_submitted=count(cl.state != S.CL_EMPTY),
        n_completed=count(done),
        n_failed=count(cl.state == S.CL_FAILED),
        makespan=torch.where(done, cl.finish_time, -float("inf")).amax(),
        mean_response=torch.nanmean(resp),
        p99_response=torch.nanquantile(resp, 0.99),
        mean_exec=torch.nanmean(exe),
        total_cost=dc.acct.total,
        cpu_cost=dc.acct.cpu_cost,
        mem_cost=dc.acct.mem_cost,
        storage_cost=dc.acct.storage_cost,
        bw_cost=dc.acct.bw_cost,
    )
