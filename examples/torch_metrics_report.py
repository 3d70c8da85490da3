"""Observability on the PyTorch port: a probed run, its bucketed
timelines and its JSON report (``examples/metrics_report.py``'s run,
through ``repro_torch``).

    PYTHONPATH=src python examples/torch_metrics_report.py [out.json] \
        [--device cpu]

Attaches an in-run metrics plane to the quickstart workload (1,000
hosts, 50 VMs, ten waves, time-shared), runs it, prints the
time-bucketed utilization and watts and the response percentiles read
straight off the plane (no per-event trace), and writes the
``repro.metrics/v1`` report, which ``python tools/check_bench.py
--report`` validates.  Runs on the CUDA device unless ``--device`` says
otherwise.
"""
import argparse
import dataclasses
import json

from repro_torch.core import broker as B
from repro_torch.core import metrics as M
from repro_torch.core import state as S
from repro_torch.core import telemetry as T
from repro_torch.core.engine import run

ap = argparse.ArgumentParser()
ap.add_argument("out", nargs="?", default="metrics_report.json")
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = args.device

N_VMS, WAVES, PERIOD = 50, 10, 600.0

hosts = S.make_uniform_hosts(1000, idle_w=100.0, peak_w=250.0, device=dev)
vms = B.build_fleet([B.VmSpec(count=N_VMS, pes=1, mips=1000.0, ram=512.0,
                              size=1000.0)], device=dev)
cloudlets = B.build_waves(N_VMS, B.WaveSpec(waves=WAVES,
                                            length_mi=1_200_000.0,
                                            period=PERIOD), device=dev)
dc = S.make_datacenter(hosts, vms, cloudlets, vm_policy=S.SPACE_SHARED,
                       task_policy=S.TIME_SHARED, reserve_pes=True,
                       device=dev)
# the plane is per-lane state: K buckets over the expected span, log-
# spaced response bins, and a 2x SLA bound on every cloudlet's ideal time
dc = dataclasses.replace(dc, metrics=M.make_metrics(
    1000, horizon=WAVES * PERIOD + 1800.0, buckets=16, sla_factor=2.0,
    device=dev))

final = run(dc, max_steps=8192)

tl = T.from_metrics(final)
print("bucket  t0[s]  dt[s]  util  watts[kW]  backlog")
for j in range(tl["bucket_start"].size):
    if tl["bucket_dt"][j] == 0.0:
        continue
    print(f"{j:>6} {tl['bucket_start'][j]:>6.0f} {tl['bucket_dt'][j]:>6.0f}"
          f" {tl['utilization'][j]:>5.2f} {tl['watts'][j] / 1e3:>9.1f}"
          f" {tl['backlog'][j]:>8.1f}")

report = T.metrics_report(final)
T.validate_metrics_report(report)
c, p = report["counters"], report["percentiles"]
print(f"retired {c['retired']}, response p50 {p['response_p50']:.0f}s "
      f"p95 {p['response_p95']:.0f}s, SLA breaches {c['sla_breaches']} "
      f"(first at {c['first_breach_t']}), peak backlog {c['peak_backlog']}")
assert c["retired"] == int((final.cloudlets.state == S.CL_DONE).sum())

with open(args.out, "w") as f:
    json.dump(report, f, indent=1)
print(f"wrote {args.out} (schema {report['schema']})")
