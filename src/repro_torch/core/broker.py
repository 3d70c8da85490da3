"""DatacenterBroker (``repro.core.broker`` in PyTorch): builds VM fleets and
cloudlet waves from user specs, and reduces a final state into the report
the user gets back (§4.2)."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import state as S
from repro_torch.spans import spanned

__all__ = ["VmSpec", "WaveSpec", "build_fleet", "build_waves",
           "BrokerReport", "collect", "nan_p99", "destroy_idle_vms"]


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


@spanned("build.fleet")
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


def nan_p99(x: torch.Tensor) -> torch.Tensor:
    """The 99th percentile of the non-NaN values of ``x`` by NumPy's
    default linear rule: sorted, position 0.99 * (n - 1), interpolated
    between its floor and its ceiling.  NaN when every value is NaN.  No
    size cap (``torch.nanquantile`` refuses more than 2^24 values), and
    no host sync."""
    x = x.reshape(-1)
    vals = torch.sort(x).values                 # NaNs sort last
    n = (~torch.isnan(x)).sum()
    pos = 0.99 * (n - 1).clamp(min=0).to(torch.float64)
    lo = pos.floor()
    a = vals[lo.long()].to(torch.float64) if x.numel() else pos
    b = vals[pos.ceil().long()].to(torch.float64) if x.numel() else pos
    p99 = a + (b - a) * (pos - lo)
    return torch.where(n > 0, p99, float("nan")).to(x.dtype)


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
        p99_response=nan_p99(resp),
        mean_exec=torch.nanmean(exe),
        total_cost=dc.acct.total,
        cpu_cost=dc.acct.cpu_cost,
        mem_cost=dc.acct.mem_cost,
        storage_cost=dc.acct.storage_cost,
        bw_cost=dc.acct.bw_cost,
    )


def destroy_idle_vms(dc: S.DatacenterState) -> S.DatacenterState:
    """VM destruction (§3.1 life cycle): release the resources of drained
    VMs.

    A VM is drained when it is ACTIVE, has no CREATED cloudlet and had
    at least one cloudlet.  It goes to ``VM_DESTROYED`` with host -1, and
    its RAM, BW and storage return to its host's pools; its PEs return
    only under ``reserve_pes``.
    """
    vms, cl, hosts = dc.vms, dc.cloudlets, dc.hosts
    nv = vms.req_pes.shape[0]
    nh = hosts.num_pes.shape[0]
    seg = torch.clamp(cl.vm, 0, nv - 1).long()
    per_vm = lambda m: torch.zeros((nv,), dtype=torch.int32,
                                   device=m.device).index_add_(
        0, seg, m.to(torch.int32))
    open_work = per_vm(cl.state == S.CL_CREATED)
    had_any = per_vm(cl.state != S.CL_EMPTY)
    drained = (vms.state == S.VM_ACTIVE) & (open_work == 0) & (had_any > 0)

    h = torch.clamp(vms.host, 0, nh - 1).long()
    w = drained.to(torch.float32)
    give = lambda pool, amt: pool.index_add(0, h, w * amt)
    reserve = torch.where(dc.reserve_pes == 1,
                          vms.req_pes.to(torch.float32), 0.0)
    return dataclasses.replace(
        dc,
        hosts=dataclasses.replace(
            hosts,
            free_ram=give(hosts.free_ram, vms.ram),
            free_bw=give(hosts.free_bw, vms.bw),
            free_storage=give(hosts.free_storage, vms.size),
            free_pes=give(hosts.free_pes, reserve)),
        vms=dataclasses.replace(
            vms,
            state=torch.where(drained, S.VM_DESTROYED,
                              vms.state).to(torch.int32),
            host=torch.where(drained, -1, vms.host).to(torch.int32)))
