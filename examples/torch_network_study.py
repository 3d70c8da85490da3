"""Network study on the PyTorch port: staged transfers under WAN
contention (the first half of ``examples/network_study.py``; its
federation-routing half needs the port of ``core/federation.py``).

One provider fleet stages every cloudlet's data behind a narrow WAN
gateway and behind a wide one: the STAGE_IN/STAGE_OUT transfers
fair-share the gateway, and the makespan stretches accordingly (the 2x2
policy grid over both fleets in one fused ``sweep.run_grid`` call).

    PYTHONPATH=src python examples/torch_network_study.py [--device cpu]

Runs on the CUDA device unless ``--device`` says otherwise.
"""
import argparse

import torch

from repro_torch.core import broker as B
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
print("staged transfers under WAN contention (narrow vs wide)")
print(f"{'policy':<12} {'narrow 25MB/s':>14} {'wide 250MB/s':>13} "
      f"{'stretch':>8}")
for p, name in enumerate(names):
    print(f"{name:<12} {float(mk[p, 0]):>12.1f} s {float(mk[p, 1]):>11.1f} s"
          f" {float(mk[p, 0] / mk[p, 1]):>7.2f}x")
print(f"staged MB per cell: {float(mb[0, 0]):.0f} (byte-conserved across "
      f"policies: {bool(torch.all(mb == mb[0, 0]))})")
assert bool(torch.all(mk[:, 0] >= mk[:, 1] - 1e-3))   # contention never helps
