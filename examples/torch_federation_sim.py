"""Federated clouds on the PyTorch port (``examples/federation_sim.py``):
datacenters register with the CIS, a broker shops user fleets to the
cheapest feasible provider, and every datacenter simulates on its own,
here as the lanes of one batch (``federation.vmap_federation``; with
``--devices N``, one run a datacenter over N entries of the device
list, ``federation.federated_run``).

    PYTHONPATH=src python examples/torch_federation_sim.py [--device cpu]

Runs on the CUDA device unless ``--device`` says otherwise.
"""
import argparse
import dataclasses

import torch

from repro_torch.core import broker as B
from repro_torch.core import cis
from repro_torch.core import federation as F
from repro_torch.core import state as S
from repro_torch.core import sweep

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--devices", type=int, default=0,
                help="run datacenter d on entry d %% N of a device list "
                     "of N entries (0: the lanes of one batch)")
args = ap.parse_args()
dev = args.device


def provider(n_hosts, cpu_rate, slots=64):
    """Three providers of different live capacity and the same array
    capacity: the difference lives in the valid mask."""
    hosts = S.make_uniform_hosts(slots, pes=2, device=dev)
    live = torch.arange(slots, device=dev) < n_hosts
    hosts = dataclasses.replace(hosts, valid=live,
                                free_ram=torch.where(live, hosts.free_ram,
                                                     0.0))
    vms = B.build_fleet([B.VmSpec(count=8, pes=1)], device=dev)
    cl = B.build_waves(8, B.WaveSpec(waves=3, length_mi=90_000.0,
                                     period=60.0), device=dev)
    return S.make_datacenter(hosts, vms, cl, reserve_pes=True,
                             rates=S.make_market(cpu_rate, 1e-3, 1e-4, 2e-3,
                                                 device=dev), device=dev)


stack = sweep.stack_scenarios([provider(32, 0.05), provider(64, 0.01),
                               provider(8, 0.02)])

# CIS registry and broker match-making (the Figure 5 flow)
table = cis.register(stack)
f32 = lambda xs: torch.tensor(xs, dtype=torch.float32, device=dev)
demand = F.UserDemand(pes=f32([16.0, 64.0, 8.0]), mips=f32([1000.0] * 3),
                      ram=f32([4096.0] * 3), storage=f32([8000.0] * 3))
assign = F.assign_users(table, demand).tolist()
for u, d in enumerate(assign):
    where = (f"DC{d} (rate ${float(table.cost_per_cpu_sec[d]):.2f}/PE-s)"
             if d >= 0 else "REJECTED (no capacity)")
    print(f"user{u} ({float(demand.pes[u]):.0f} PEs) -> {where}")

# run the federation
if args.devices:
    final, reports, _ = F.federated_run(stack, devices=[dev] * args.devices,
                                        max_steps=512)
else:
    final, reports, _ = F.vmap_federation(stack, max_steps=512)
for i in range(3):
    print(f"DC{i}: completed {int(reports.n_completed[i])}/24, "
          f"makespan {float(reports.makespan[i]):.0f}s, "
          f"revenue ${float(reports.total_cost[i]):.2f}")
