"""Inter-cloud policy study on the PyTorch port (``examples/
intercloud_study.py``'s workload, one fused batch).

Five users shop VM fleets across three providers of different capacity
and price; the CIS and the broker route every fleet to the cheapest
feasible datacenter, then every (policy, datacenter) cell of the 2x2
scheduling matrix runs as one lane of a fused batch (CloudSim would run
P*D separate simulations).  ``--devices N`` deals the lanes over N
entries of the device list (the lane dispatcher, ``sweep.run_sharded``);
on one card the entries are the same card.

    PYTHONPATH=src python examples/torch_intercloud_study.py [--device cpu]

Runs on the CUDA device unless ``--device`` says otherwise.
"""
import argparse

import torch

from repro_torch.core import broker as B
from repro_torch.core import experiments as E
from repro_torch.core import state as S
from repro_torch.core import sweep

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--devices", type=int, default=0,
                help="split the lanes over this many entries of the "
                     "device list (0: one fused batch)")
args = ap.parse_args()
dev = args.device
market = lambda rate: S.make_market(rate, 1e-3, 1e-4, 2e-3, device=dev)
providers = [
    E.Provider(S.make_uniform_hosts(12, pes=2, device=dev),
               market(0.05)),                             # pricey, mid-size
    E.Provider(S.make_uniform_hosts(20, pes=2, device=dev),
               market(0.01)),                             # cheap, large
    E.Provider(S.make_uniform_hosts(6, pes=2, device=dev),
               market(0.02)),                             # cheap-ish, small
]

# ram=256 lets four 1-PE VMs share a 2-PE/1GB host: VMs outnumber cores,
# waves overlap their own execution, and the four policies diverge
fleets = [
    E.UserFleet((B.VmSpec(count=c, pes=1, ram=256.0),),
                B.WaveSpec(waves=w, length_mi=length, period=period))
    for c, w, length, period in [(20, 3, 240_000.0, 120.0),
                                 (16, 4, 120_000.0, 60.0),
                                 (12, 2, 360_000.0, 300.0),
                                 (8, 5, 60_000.0, 30.0),
                                 (12, 3, 180_000.0, 90.0)]]

# reserve_pes=False: VMs share hosts and queue for cores (Figure 3)
vm_p, task_p = sweep.policy_grid(device=dev)
study = E.run_study(providers, fleets, vm_p, task_p, max_steps=4096,
                    reserve_pes=False, device=dev,
                    devices=[dev] * args.devices or None)

assign = study.assignment.tolist()
rates = study.table.cost_per_cpu_sec.tolist()
print(f"routing over {len(providers)} providers (on {dev}):")
for u, d in enumerate(assign):
    where = f"DC{d} (${rates[d]:.2f}/PE-s)" if d >= 0 else "REJECTED"
    print(f"  user{u} -> {where}")

names = ["space/space", "space/time", "time/space", "time/time"]
done = study.summary.n_done.cpu()                 # [P, D]
resp = study.summary.mean_response.cpu()          # [P, D]
# federation mean response: each DC weighted by its completed cloudlets
fed_resp = (resp * done).sum(-1) / torch.clamp(done.sum(-1), min=1)
print(f"\n{'policy (vm/task)':>16} | per-DC mean response (s) "
      f"| fed mean resp | fed makespan | fed bill")
for p, name in enumerate(names):
    per_dc = " ".join(f"{float(resp[p, d]):7.0f}"
                      for d in range(len(providers)))
    print(f"{name:>16} | {per_dc}  | {float(fed_resp[p]):13.0f} "
          f"| {float(study.fed_makespan[p]):11.0f}s "
          f"| ${float(study.fed_cost[p]):7.2f}")
cells = done.shape[0] * done.shape[1]
print(f"\n({cells} (policy, datacenter) simulations in one fused batch; "
      f"{int(done.sum())} cloudlets completed)")
