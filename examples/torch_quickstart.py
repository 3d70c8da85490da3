"""Quickstart on the PyTorch port: the paper's §5 experiment in 30 lines.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Builds a datacenter (paper host class), deploys a 50-VM fleet through the
broker, submits 10 waves of 20-minute tasks, runs the discrete-event
engine to quiescence under both task policies, and prints the Fig 8/9
contrast.  Runs on the CUDA device unless ``--device`` says otherwise.
"""
import argparse

from repro_torch.core import broker as B
from repro_torch.core import state as S
from repro_torch.core.engine import run

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

for policy, name in ((S.SPACE_SHARED, "space-shared (Fig 8)"),
                     (S.TIME_SHARED, "time-shared  (Fig 9)")):
    hosts = S.make_uniform_hosts(1000, device=dev)  # 1 PE @1000 MIPS, 1GB
    vms = B.build_fleet([B.VmSpec(count=50, pes=1, mips=1000.0,
                                  ram=512.0, size=1000.0)], device=dev)
    cloudlets = B.build_waves(50, B.WaveSpec(waves=10,
                                             length_mi=1_200_000.0,
                                             period=600.0), device=dev)
    dc = S.make_datacenter(hosts, vms, cloudlets,
                           vm_policy=S.SPACE_SHARED, task_policy=policy,
                           reserve_pes=True,
                           rates=S.make_market(0.01, 0.001, 1e-4, 0.002,
                                               device=dev), device=dev)
    final = run(dc, max_steps=8192)
    report = B.collect(final)
    exec_t = (final.cloudlets.finish_time
              - final.cloudlets.start_time).cpu().numpy()
    print(f"{name}: {int(report.n_completed)}/500 done, "
          f"exec {exec_t.min():.0f}-{exec_t.max():.0f}s, "
          f"mean response {float(report.mean_response):.0f}s, "
          f"makespan {float(report.makespan):.0f}s, "
          f"bill ${float(report.total_cost):.2f}")
