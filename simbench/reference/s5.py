"""A plain reference of the §5 scenario under the Fig. 3 policy grid.

Written from the paper's semantics and CloudSim's event rules, in plain
PyTorch, for any number of lanes at once.  It imports nothing of the
program and takes nothing the program made: its inputs are
``generate.Scenario`` arrays and the configuration.

What it models, lane by lane:

* provisioning: first fit of identical VM requests in slot order, with
  the RAM, bandwidth, storage, MIPS and (reserved) PE checks; a VM no
  host admits fails, and so do its cloudlets.  Memory and storage are
  billed at creation.  The configurations place at most one VM on a
  host; the reference refuses others (a host shared by VMs would need
  the host-level share, which these cells do not exercise);
* a VM alone on its host gets ``pes * min(vm mips, host mips)``;
  space-shared tasks take the VM's PEs in FCFS order, time-shared ones
  share its capacity equally (``capacity / max(running, pes)``);
* events: the clock jumps to the earliest completion or arrival of its
  lane.  A cloudlet whose time to finish is within
  ``dt * (1 + 1e-5) + 1e-9`` of the jump completes with it (CloudSim's
  snap band, which the port mirrors), so near ties merge into one
  event.  The lane stops when nothing runs and nothing is to come;
* energy: a host draws ``idle + (peak - idle) * utilization`` watts
  between events, idle hosts too, until its lane's last event;
* the market: CPU per PE-second executed, bandwidth per MB of each
  completed cloudlet's input and output, memory and storage per VM
  placed.

``dtype`` sets the precision of every float (float64 for the reference,
bfloat16 for the control).  ``ambiguous`` counts the events where a
finish time lies within ``AMBIGUOUS_S`` of the snap band's edge, or a
completion within ``AMBIGUOUS_S`` of an arrival: there an f32 program
may merge two of the reference's events or split one, so the event
counts may differ by one each.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["LaneResult", "simulate", "AMBIGUOUS_S", "SNAP_REL",
           "SNAP_ABS"]

SNAP_REL = 1e-5
SNAP_ABS = 1e-9
AMBIGUOUS_S = 1e-2
INF = float("inf")


@dataclasses.dataclass
class LaneResult:
    """Every lane's answers (leading axis N, the lanes given).  The
    cloudlet arrays are in the scenario's slot order: ``[n, k, w]`` is
    wave ``w`` of VM ``order[k]``, slot ``k*W + w``."""
    vm_host: torch.Tensor       # i64[N, V]  -1 when it failed
    vm_placed: torch.Tensor     # bool[N, V]
    cl_live: torch.Tensor       # bool[N, K, W]  its VM was placed
    cl_done: torch.Tensor       # bool[N, K, W]
    start: torch.Tensor         # [N, K, W]  -1 before it ran
    finish: torch.Tensor        # [N, K, W]  inf unless done
    host_energy: torch.Tensor   # [N, H]  J
    events: torch.Tensor        # i64[N]
    ambiguous: torch.Tensor     # i64[N]
    n_done: torch.Tensor        # i64[N]
    makespan: torch.Tensor      # [N]  0 when nothing completed
    mean_response: torch.Tensor  # [N]
    energy_j: torch.Tensor      # [N]
    mem_cost: torch.Tensor      # [N]
    storage_cost: torch.Tensor  # [N]
    total_cost: torch.Tensor    # [N]


def _first_fit(config: dict):
    """(host of each VM or -1, placed) under first fit of identical
    requests: each host admits as many as every pool holds, and the
    requests fill the hosts in index order."""
    h, v = config["hosts"], config["vms"]
    n_hosts, n_vms = int(h["count"]), int(v["count"])
    holds = min(int(h["ram"] // v["ram"]), int(h["bw"] // v["bw"]),
                int(h["storage"] // v["size"]))
    if config["reserve_pes"]:
        holds = min(holds, int(h["pes"] // v["pes"]))
    elif h["pes"] < v["pes"]:
        holds = 0
    if h["mips"] < v["mips"]:
        holds = 0
    if holds > 1:
        raise NotImplementedError("the reference models one VM a host")
    host = np.arange(n_vms, dtype=np.int64)
    placed = host < holds * n_hosts
    return np.where(placed, host, -1), placed


def simulate(config: dict, scenarios, policies, *, dtype=torch.float64,
             device="cpu") -> LaneResult:
    """Run lanes ``(scenarios[i], policies[i])`` to quiescence.

    ``scenarios`` are ``generate.Scenario``s of one configuration,
    ``policies`` (vm_policy, task_policy) pairs; 0 is space-shared,
    1 time-shared.  A lane whose clock a coarse precision cannot advance
    stops there, its work unfinished."""
    dev = torch.device(device)
    h, v, w = config["hosts"], config["vms"], config["waves"]
    n_hosts, n_vms, n_waves = (int(h["count"]), int(v["count"]),
                               int(w["count"]))
    n = len(scenarios)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev
                                  ).to(dtype)
    shape = (n, n_vms, n_waves)
    for s in scenarios:
        if not (np.array_equal(np.sort(s.order), np.arange(n_vms))
                and np.array_equal(s.vm, np.repeat(s.order, n_waves))):
            raise ValueError("cloudlets must be grouped by VM, W a VM")
    # the lanes run with VM v's cloudlets at [n, v, :]; the answers go
    # back to slot order at the end
    order = torch.as_tensor(np.stack([s.order for s in scenarios]),
                            device=dev)[:, :, None].expand(shape)
    inv = torch.argsort(order, dim=1)
    length = f(np.stack([s.length for s in scenarios])).reshape(
        shape).gather(1, inv)
    submit = f(np.stack([s.submit for s in scenarios])).reshape(
        shape).gather(1, inv)
    task = torch.tensor([p[1] for p in policies], device=dev)[:, None, None]

    host_np, placed_np = _first_fit(config)
    placed = torch.as_tensor(placed_np, device=dev)[None].expand(n, -1)
    pes = float(v["pes"])
    cap_v = pes * min(float(v["mips"]), float(h["mips"]))
    host_cap = float(h["pes"]) * float(h["mips"])
    idle, peak = float(h["idle_w"]), float(h["peak_w"])
    mips_pe = float(h["mips"])
    live_cl = placed[:, :, None].expand(shape)

    zero = torch.zeros((), dtype=dtype, device=dev)
    t = torch.zeros(n, dtype=dtype, device=dev)
    rem = length.clone()
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    start = torch.full(shape, -1.0, dtype=dtype, device=dev)
    finish = torch.full(shape, INF, dtype=dtype, device=dev)
    e_vm = torch.zeros((n, n_vms), dtype=dtype, device=dev)
    pe_s = torch.zeros(n, dtype=dtype, device=dev)
    events = torch.zeros(n, dtype=torch.long, device=dev)
    ambiguous = torch.zeros(n, dtype=torch.long, device=dev)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    for _ in range(n_vms * n_waves + n_waves + 1):
        tt = t[:, None, None]
        run = live_cl & ~done & (submit <= tt) & (rem > 0)
        rank = torch.cumsum(run.long(), dim=2) - 1
        n_run = run.sum(dim=2, keepdim=True).to(dtype)
        space = torch.where(rank < int(pes), cap_v / pes, zero)
        share = cap_v / torch.clamp(n_run, min=pes)
        rate = torch.where(run, torch.where(task == 0, space, share), zero)
        going = rate > 0
        fin_dt = torch.where(going, rem / torch.where(going, rate, 1.0),
                             INF)
        dtc = fin_dt.amin(dim=(1, 2))
        ahead = live_cl & (submit > tt)
        dta = torch.where(ahead, submit - tt, INF).amin(dim=(1, 2))
        dt = torch.minimum(dtc, dta)
        live = live & torch.isfinite(dt)
        if not bool(live.any()):
            break
        dt = torch.where(live, dt, zero)
        snap = (dt * (1.0 + SNAP_REL) + SNAP_ABS)[:, None, None]
        ends = going & (fin_dt <= snap) & live[:, None, None]
        edge = (going & ((fin_dt - snap).abs() < AMBIGUOUS_S)
                & (fin_dt != dtc[:, None, None])).flatten(1).any(dim=1)
        near = (dtc - dta).abs() < AMBIGUOUS_S
        ambiguous += (live & (edge | near)).long()
        lv = live[:, None, None]
        start = torch.where(lv & going & (start < 0), tt, start)
        step = rate * dt[:, None, None]
        rem = torch.where(ends, zero, torch.where(
            lv, torch.clamp(rem - step, min=0.0), rem))
        finish = torch.where(ends, (t + dt)[:, None, None], finish)
        done = done | ends
        util = rate.sum(dim=2) / host_cap
        e_vm = e_vm + (idle + (peak - idle) * util) * dt[:, None]
        pe_s = pe_s + step.flatten(1).sum(dim=1) / mips_pe
        events += live.long()
        later = t + dt
        # a lane whose clock cannot advance and that finishes nothing
        # would repeat this event forever: it stops
        stuck = (later == t) & ~ends.flatten(1).any(dim=1)
        t = torch.where(live, later, t)
        live = live & ~stuck

    r = config["rates"]
    n_placed = placed.sum(dim=1).to(dtype)
    n_done = done.flatten(1).sum(dim=1)
    moved = n_done.to(dtype) * (float(w["file_size"])
                                + float(w["output_size"]))
    mem = n_placed * (float(r["mem"]) * float(v["ram"]))
    sto = n_placed * (float(r["storage"]) * float(v["size"]))
    total = pe_s * float(r["cpu"]) + moved * float(r["bw"]) + mem + sto
    # hosts without a VM draw idle watts until their lane's last event
    e_host = (idle * t)[:, None].expand(n, n_hosts).clone()
    vm_host = torch.as_tensor(host_np, device=dev)
    on = vm_host >= 0
    e_host[:, vm_host[on]] = e_vm[:, on]
    resp = torch.where(done, finish - submit, zero).flatten(1).sum(dim=1)
    slots = lambda x: x.gather(1, order)
    return LaneResult(
        vm_host=vm_host[None].expand(n, -1), vm_placed=placed,
        cl_live=slots(live_cl), cl_done=slots(done), start=slots(start),
        finish=slots(finish), host_energy=e_host,
        events=events, ambiguous=ambiguous, n_done=n_done,
        makespan=torch.where(done, finish, zero).flatten(1).amax(dim=1),
        mean_response=resp / torch.clamp(n_done.to(dtype), min=1.0),
        energy_j=e_host.sum(dim=1), mem_cost=mem, storage_cost=sto,
        total_cost=total)
