"""Migration study on the PyTorch port: consolidation and resilience
under host failures (``examples/migration_study.py``'s configurations).

  1. The 2x2 space/time-shared grid over a contended fleet, healthy and
     losing two hosts mid-run (timed EV_HOST_FAIL rows, one later
     EV_HOST_RECOVER), in one fused ``sweep.run_grid`` call; evicted VMs
     re-provision onto surviving capacity.
  2. THRESHOLD offload against migration off under the outage: first fit
     packs the fleet onto few hosts, and the policy spreads the hotspot.
  3. DRAIN consolidation from a WORST_FIT spread start, under a concave
     SPECpower curve: packing VMs upward burns fewer joules.

    PYTHONPATH=src python examples/torch_migration_study.py [--device cpu]

Runs on the CUDA device unless ``--device`` says otherwise.
"""
import argparse

from repro_torch.core import broker as B
from repro_torch.core import energy
from repro_torch.core import state as S
from repro_torch.core import sweep
from repro_torch.core.provisioning import WORST_FIT

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

IDLE_W, PEAK_W, G5 = energy.normalize_watts(energy.SPEC_G5_WATTS,
                                            device=dev)


def scenario(*, events=None, mig_policy=S.MIG_OFF, mig_threshold=0.8):
    hosts = S.make_uniform_hosts(12, pes=2, mips=1000.0, ram=4096.0,
                                 idle_w=IDLE_W, peak_w=PEAK_W,
                                 power_curve=G5, device=dev)
    vms = B.build_fleet([B.VmSpec(count=20, pes=1, mips=1000.0, ram=256.0,
                                  size=100.0)], device=dev)
    cl = B.build_waves(20, B.WaveSpec(waves=3, length_mi=240_000.0,
                                      period=150.0), device=dev)
    return S.make_datacenter(hosts, vms, cl, reserve_pes=False,
                             events=events, mig_policy=mig_policy,
                             mig_threshold=mig_threshold,
                             mig_energy_per_mb=0.01, device=dev)


def row(summ, i):
    return (f"{int(summ.n_migrations[i]):3d} migs  "
            f"{float(summ.mig_downtime[i]):6.1f}s down  "
            f"makespan {float(summ.makespan[i]):7.0f}s  "
            f"{float(summ.energy_j[i]) / 1e3:6.1f}kJ")


# 1. the Fig. 3 policy matrix while two hosts fail mid-run
outage = S.make_events([150.0, 300.0, 600.0],
                       [S.EV_HOST_FAIL, S.EV_HOST_FAIL, S.EV_HOST_RECOVER],
                       [0, 1, 0], device=dev)
batch = sweep.stack_scenarios([scenario(), scenario(events=outage)])
grid = sweep.run_grid(batch, *sweep.policy_grid(device=dev), max_steps=8192)
summ = sweep.summarize_batch(grid)
names = ["space/space", "space/time", "time/space", "time/time"]
print("policy matrix: healthy fleet vs 2-host outage "
      "(makespan s / done / kJ)")
for p, name in enumerate(names):
    mk, done, en = summ.makespan[p], summ.n_done[p], summ.energy_j[p]
    print(f"  {name:12s} healthy {float(mk[0]):7.0f}s {int(done[0]):3d} "
          f"{float(en[0]) / 1e3:6.1f}kJ | outage {float(mk[1]):7.0f}s "
          f"{int(done[1]):3d} {float(en[1]) / 1e3:6.1f}kJ")
assert bool((summ.n_done[:, 0] == 60).all()), \
    "the healthy fleet must finish everything"

# 2. THRESHOLD offload: first fit packs the VMs; the policy spreads them
cases = {
    "mig OFF": scenario(events=outage),
    "THRESHOLD .7": scenario(events=outage, mig_policy=S.MIG_THRESHOLD,
                             mig_threshold=0.7),
}
msumm = sweep.summarize_batch(sweep.run_batch(
    sweep.stack_scenarios(list(cases.values())), max_steps=8192))
print("\nTHRESHOLD offload under the outage (first-fit hotspot start)")
for i, name in enumerate(cases):
    print(f"  {name:14s} {row(msumm, i)}")
assert int(msumm.n_migrations[1]) > 0


# 3. DRAIN consolidation from a WORST_FIT spread start
def drain_scenario(**kw):
    hosts = S.make_uniform_hosts(8, pes=4, mips=1000.0, ram=4096.0,
                                 idle_w=IDLE_W, peak_w=PEAK_W,
                                 power_curve=G5, device=dev)
    # 13 VMs over 8 hosts: the uneven spread (2,2,2,2,2,1,1,1); DRAIN
    # peels the lightest hosts empty
    vms = B.build_fleet([B.VmSpec(count=13, pes=1, mips=1000.0, ram=256.0,
                                  size=100.0)], device=dev)
    cl = B.build_waves(13, B.WaveSpec(waves=3, length_mi=240_000.0,
                                      period=260.0), device=dev)
    return S.make_datacenter(hosts, vms, cl, reserve_pes=False,
                             mig_energy_per_mb=0.01, device=dev, **kw)


dcases = {
    "spread, no mig": drain_scenario(),
    "spread + DRAIN": drain_scenario(mig_policy=S.MIG_DRAIN,
                                     mig_threshold=0.3),
}
dsumm = sweep.summarize_batch(sweep.run_batch(
    sweep.stack_scenarios(list(dcases.values())), max_steps=8192,
    provision_policy=WORST_FIT))
print("\nDRAIN consolidation from a WORST_FIT spread start")
for i, name in enumerate(dcases):
    print(f"  {name:14s} {row(dsumm, i)}")
print(f"\nDRAIN consolidated with {int(dsumm.n_migrations[1])} migrations.")
