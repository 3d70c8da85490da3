"""Network study on the PyTorch port (``examples/network_study.py``):

  1. *WAN contention*: one provider fleet stages every cloudlet's data
     behind a narrow WAN gateway and behind a wide one; the
     STAGE_IN/STAGE_OUT transfers fair-share the gateway, and the
     makespan stretches accordingly (the 2x2 policy grid over both
     fleets in one fused ``sweep.run_grid`` call).
  2. *Latency-aware federation routing*: users in a far region shop a
     cheap-but-far provider and a pricier-but-near one.  The
     latency-blind broker piles everyone onto the cheap provider's
     narrow WAN; the latency-weighted broker (a latency matrix and
     ``latency_weight`` through ``experiments.run_study``) splits by
     region and finishes earlier.

    PYTHONPATH=src python examples/torch_network_study.py [--device cpu]

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
dev = ap.parse_args().device


def fleet_scenario(*, bw_wan):
    """20 VMs x 3 cloudlet waves, 100 MB in / 40 MB out each, behind a
    two-cluster topology whose WAN gateway is the contended tier.  Per
    wave the fleet pulls 2 GB through the gateway: 80 s at 25 MB/s vs
    8 s at 250 MB/s against 60 s of compute."""
    hosts = S.make_uniform_hosts(10, pes=2, mips=1000.0, ram=4096.0,
                                 device=dev)
    net = S.make_topology([i % 2 for i in range(10)], bw_intra=500.0,
                          lat_intra=0.001, bw_inter=200.0, lat_inter=0.005,
                          bw_wan=bw_wan, lat_wan=0.05, device=dev)
    vms = B.build_fleet([B.VmSpec(count=20, pes=1, mips=1000.0, ram=256.0,
                                  size=100.0)], device=dev)
    cl = B.build_waves(20, B.WaveSpec(waves=3, length_mi=60_000.0,
                                      period=60.0, file_size=100.0,
                                      output_size=40.0), device=dev)
    return S.make_datacenter(hosts, vms, cl, reserve_pes=True, net=net,
                             device=dev)


batch = sweep.stack_scenarios([fleet_scenario(bw_wan=25.0),
                               fleet_scenario(bw_wan=250.0)])
grid = sweep.run_grid(batch, *sweep.policy_grid(device=dev), max_steps=8192)
summ = sweep.summarize_batch(grid)
mk, mb = summ.makespan.cpu(), summ.transferred_mb.cpu()
names = ["space/space", "space/time", "time/space", "time/time"]
print("=== 1. staged transfers under WAN contention (narrow vs wide) ===")
print(f"{'policy':<12} {'narrow 25MB/s':>14} {'wide 250MB/s':>13} "
      f"{'stretch':>8}")
for p, name in enumerate(names):
    print(f"{name:<12} {float(mk[p, 0]):>12.1f} s {float(mk[p, 1]):>11.1f} s"
          f" {float(mk[p, 0] / mk[p, 1]):>7.2f}x")
print(f"staged MB per cell: {float(mb[0, 0]):.0f} (byte-conserved across "
      f"policies: {bool(torch.all(mb == mb[0, 0]))})")
assert bool(torch.all(mk[:, 0] >= mk[:, 1] - 1e-3))   # contention never helps

# ---------------------------------------------------------------------------
# 2. Latency-aware vs latency-blind federation routing
# ---------------------------------------------------------------------------
topology = lambda bw_wan, lat_wan: S.make_topology(
    [0] * 8, bw_intra=500.0, bw_inter=200.0, bw_wan=bw_wan, lat_wan=lat_wan,
    device=dev)
park = lambda: S.make_uniform_hosts(8, pes=2, ram=4096.0, device=dev)
market = lambda rate: S.make_market(rate, 1e-3, 1e-4, 2e-3, device=dev)
providers = [
    # cheap, but far from the users and behind a narrow gateway
    E.Provider(park(), market(0.01), net=topology(20.0, 0.25)),
    # pricier, near, wide gateway
    E.Provider(park(), market(0.03), net=topology(100.0, 0.01)),
]
fleets = [E.UserFleet((B.VmSpec(count=4, pes=1, ram=256.0),),
                      B.WaveSpec(waves=2, length_mi=30_000.0, period=60.0,
                                 file_size=120.0, output_size=30.0))
          for _ in range(4)]
# all four users live in region 1 (provider 1's region)
latency = torch.tensor([[0.0, 0.4], [0.4, 0.005]], dtype=torch.float32)
origin = torch.tensor([1, 1, 1, 1], dtype=torch.int32)
vm_p, task_p = sweep.policy_grid(device=dev)

print("\n=== 2. federation routing: latency-blind vs latency-aware ===")
rows = []
for name, weight in (("latency-blind", 0.0), ("latency-aware", 0.1)):
    study = E.run_study(providers, fleets, vm_p, task_p, max_steps=8192,
                        reserve_pes=True, latency=latency, origin=origin,
                        latency_weight=weight, device=dev)
    assign = study.assignment.tolist()
    mk = float(study.fed_makespan[1])              # the space/time row
    cost = float(study.fed_cost[1])
    mb = float(study.fed_transferred_mb[1])
    rows.append((name, assign, mk, cost, mb))
    print(f"{name:<14} assignment={assign} "
          f"makespan={mk:7.1f} s  cost=${cost:6.2f}  staged={mb:.0f} MB")

blind, aware = rows
assert all(d == 0 for d in blind[1])    # everyone chases the low price
assert any(d == 1 for d in aware[1])    # the near provider wins users
# spreading load off the congested narrow WAN finishes the work earlier
assert aware[2] <= blind[2] + 1e-3
print(f"latency-aware routing cuts federation makespan "
      f"{blind[2]:.1f} -> {aware[2]:.1f} s "
      f"({100 * (1 - aware[2] / blind[2]):.0f}%) at "
      f"${aware[3] - blind[3]:+.2f} market cost")
