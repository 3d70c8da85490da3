"""Energy study on the PyTorch port: the power/performance trade-off the
paper motivates (``examples/energy_study.py``'s configurations).

  1. *Scheduling*: the 2x2 space/time-shared policy matrix over a
     contended fleet, one fused ``sweep.run_grid`` call, comparing
     makespan, mean response and fleet energy per policy cell.
  2. *Provisioning*: first-fit / round-robin spread against MOST_FULL
     consolidation under a concave SPECpower-style curve, where packing
     strands idle hosts at the curve floor and cuts joules at equal
     makespan.

    PYTHONPATH=src python examples/torch_energy_study.py [--device cpu]

Runs on the CUDA device unless ``--device`` says otherwise.
"""
import argparse

import numpy as np

from repro_torch.core import broker as B
from repro_torch.core import energy
from repro_torch.core import state as S
from repro_torch.core import sweep
from repro_torch.core.engine import run
from repro_torch.core.provisioning import FIRST_FIT, MOST_FULL, ROUND_ROBIN

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

# ---------------------------------------------------------------------------
# 1. Scheduling policies x energy: the Fig 3 matrix with watts attached
# ---------------------------------------------------------------------------
IDLE_W, PEAK_W, G5 = energy.normalize_watts(energy.SPEC_G5_WATTS,
                                            device=dev)


def scenario(n_vms, waves, length_mi, period):
    hosts = S.make_uniform_hosts(16, pes=2, mips=1000.0, ram=4096.0,
                                 idle_w=IDLE_W, peak_w=PEAK_W,
                                 power_curve=G5, device=dev)
    vms = B.build_fleet([B.VmSpec(count=n_vms, pes=1, mips=1000.0,
                                  ram=256.0, size=100.0)], device=dev)
    cl = B.build_waves(n_vms, B.WaveSpec(waves=waves, length_mi=length_mi,
                                         period=period), device=dev)
    # reserve_pes=False: VMs co-host and queue for cores, the contention
    # that differentiates the four policy combinations (cf. Figure 3)
    return S.make_datacenter(hosts, vms, cl, reserve_pes=False, device=dev)


batch = sweep.stack_scenarios([
    scenario(48, 3, 240_000.0, 120.0),      # heavy: 48 VMs on 32 cores
    scenario(24, 4, 120_000.0, 90.0),       # light: fleet half-drained
])
vm_p, task_p = sweep.policy_grid(device=dev)
grid = sweep.run_grid(batch, vm_p, task_p, max_steps=4096)
summ = sweep.summarize_batch(grid)

names = ["space/space", "space/time", "time/space", "time/time"]
mk = summ.makespan.cpu().numpy()          # [P, B] s
resp = summ.mean_response.cpu().numpy()   # [P, B] s
en = summ.energy_j.cpu().numpy()          # [P, B] J
done = summ.n_done.cpu().numpy()

print("scheduling policy x energy (16 hosts x 2 PEs, SPECpower G5 curve,"
      f" {IDLE_W:.0f}-{PEAK_W:.0f} W):")
print(f"{'policy (vm/task)':>16} | {'scenario':>8} | {'done':>4} "
      f"| {'makespan':>9} | {'mean resp':>9} | {'energy':>9}")
for p, name in enumerate(names):
    for b, load in enumerate(("heavy", "light")):
        print(f"{name:>16} | {load:>8} | {done[p, b]:4d} "
              f"| {mk[p, b]:8.0f}s | {resp[p, b]:8.0f}s "
              f"| {en[p, b] / 1e6:6.2f} MJ")

# ---------------------------------------------------------------------------
# 2. Provisioning: spread vs consolidation at equal work
# ---------------------------------------------------------------------------
concave = np.linspace(0.0, 1.0, energy.K_CURVE) ** 0.25
hosts = S.make_uniform_hosts(16, pes=2, mips=1000.0, ram=4096.0,
                             idle_w=IDLE_W, peak_w=PEAK_W,
                             power_curve=concave, device=dev)
vms = B.build_fleet([B.VmSpec(count=16, pes=1, mips=1000.0, ram=256.0,
                              size=100.0)], device=dev)
cl = B.build_waves(16, B.WaveSpec(waves=2, length_mi=120_000.0,
                                  period=60.0), device=dev)
dc = S.make_datacenter(hosts, vms, cl, vm_policy=S.SPACE_SHARED,
                       task_policy=S.SPACE_SHARED, reserve_pes=True,
                       device=dev)

print("\nprovisioning x energy (concave curve, reserve_pes placement):")
print(f"{'policy':>12} | {'hosts used':>10} | {'makespan':>9} "
      f"| {'energy':>9}")
for pname, policy in (("first-fit", FIRST_FIT),
                      ("round-robin", ROUND_ROBIN),
                      ("most-full", MOST_FULL)):
    final = run(dc, max_steps=4096, provision_policy=policy)
    used = np.unique(final.vms.host.cpu().numpy())
    used = used[used >= 0].size
    e = float(energy.energy_total_j(final))
    t = float(final.time)
    print(f"{pname:>12} | {used:10d} | {t:8.0f}s | {e / 1e3:6.1f} kJ")

print("\n(energy = integral of each host's utilization->power curve over "
      "the event timeline;\n engine and NumPy oracle agree within 1e-3 J — "
      "see docs/energy.md)")
