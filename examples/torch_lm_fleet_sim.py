"""LM-fleet capacity planning on the PyTorch port: CloudSim simulating an
LM serving fleet (``examples/lm_fleet_sim.py``'s study).

    PYTHONPATH=src python examples/torch_lm_fleet_sim.py [roofline.json] \
        [--device cpu]

Converts a roofline JSON (``arch``, ``shape``, ``chips``,
``cost_per_device.flops``, ``memory.peak_bytes_per_device``; or a
built-in qwen2-1.5b prefill profile) into cloudlet terms (1 MI = 1e6
FLOPs, one simulated chip = ``TPU_V5E_MIPS``), then asks a provider
question the roofline alone cannot answer: how many serving replicas keep
p99 latency under an SLO as request rate grows, under space- against
time-shared chip allocation?  Runs on the CUDA device unless
``--device`` says otherwise.
"""
import argparse
import json

from repro_torch.core import broker as B
from repro_torch.core import state as S
from repro_torch.core.engine import run
from repro_torch.core.provisioning import WORST_FIT
from repro_torch.core.workloads import (
    cloudlets_from_profile,
    make_tpu_hosts,
    profile_from_roofline,
)

ap = argparse.ArgumentParser()
ap.add_argument("profile", nargs="?", default=None)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = args.device

if args.profile:
    with open(args.profile) as f:
        art = json.load(f)
    prof = profile_from_roofline(
        f"{art['arch']}/{art['shape']}",
        hlo_gflops=art["cost_per_device"]["flops"] * art["chips"] / 1e9,
        hbm_bytes_per_chip=art["memory"]["peak_bytes_per_device"],
        chips=art["chips"])
else:
    # qwen2-1.5b prefill_32k ballpark: 2 * 1.5e9 * 32768 ~ 98 TFLOP/request
    prof = profile_from_roofline("qwen2-1.5b/prefill_32k(builtin)",
                                 hlo_gflops=2 * 1.5 * 32768.0,
                                 hbm_bytes_per_chip=4e9, chips=1)

print(f"workload: {prof.name} = {prof.length_mi/1e6:.2f} TFLOP/request "
      f"(~{prof.length_mi/1e6/197:.2f}s service time/chip)")
print("16 request streams, 1.25 req/s each (~10 chips of offered load):")
print(f"{'chips':>6} | {'policy':>6} | {'mean (s)':>8} | {'p99 (s)':>8} "
      f"| {'done':>5}")

N_STREAMS = 16
for n_chips in (4, 8, 16):
    for pol, pname in ((S.SPACE_SHARED, "space"), (S.TIME_SHARED, "time")):
        hosts = make_tpu_hosts(n_chips, device=dev)
        # many serving VMs co-hosted per chip: no PE reservation,
        # time-shared chip allocation across VMs
        vms = B.build_fleet([B.VmSpec(count=N_STREAMS, pes=1, mips=197e6,
                                      ram=1024.0, size=100.0)], device=dev)
        cl = cloudlets_from_profile(prof, N_STREAMS, requests_per_vm=12,
                                    period=0.8, device=dev)
        dc = S.make_datacenter(hosts, vms, cl, vm_policy=S.TIME_SHARED,
                               task_policy=pol, reserve_pes=False,
                               device=dev)
        # WORST_FIT spreads serving VMs across chips (first-fit would
        # stack all 16 onto chip 0 and leave the fleet idle)
        rep = B.collect(run(dc, max_steps=4096, provision_policy=WORST_FIT))
        print(f"{n_chips:>6} | {pname:>6} "
              f"| {float(rep.mean_response):8.3f} "
              f"| {float(rep.p99_response):8.3f} "
              f"| {int(rep.n_completed):>5}")
