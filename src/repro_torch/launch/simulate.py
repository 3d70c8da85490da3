"""Cloud-simulation driver — the paper's user-code layer as a CLI, on the
PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.simulate --hosts 10000 \
        --vms 50 --waves 10 --task-policy time [--device cpu]

Reproduces the §5 experiment at any scale and prints the broker report
and, with ``--trace N``, a completion curve of N steps.  With
``--lm-profile FILE`` it simulates an LM-serving fleet instead, sized
from a roofline JSON (``arch``, ``shape``, ``chips``,
``cost_per_device.flops``, ``memory.peak_bytes_per_device``).  Runs on
the CUDA device unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", type=int, default=1000)
    ap.add_argument("--vms", type=int, default=50)
    ap.add_argument("--waves", type=int, default=10)
    ap.add_argument("--wave-period", type=float, default=600.0)
    ap.add_argument("--task-mi", type=float, default=1_200_000.0)
    ap.add_argument("--vm-policy", default="space",
                    choices=["space", "time"])
    ap.add_argument("--task-policy", default="space",
                    choices=["space", "time"])
    ap.add_argument("--cpu-rate", type=float, default=0.01)
    ap.add_argument("--lm-profile", default=None,
                    help="roofline JSON: simulate that LM workload instead")
    ap.add_argument("--trace", type=int, default=0,
                    help="emit a completion curve with N trace steps")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.core import broker as B
    from repro_torch.core import state as S
    from repro_torch.core.engine import run, run_trace
    from repro_torch.core.telemetry import completion_curve, summarize_trace

    pol = {"space": S.SPACE_SHARED, "time": S.TIME_SHARED}
    dev = args.device
    if args.lm_profile:
        from repro_torch.core.workloads import (cloudlets_from_profile,
                                                make_tpu_hosts,
                                                profile_from_roofline)
        with open(args.lm_profile) as f:
            art = json.load(f)
        prof = profile_from_roofline(
            f"{art['arch']}/{art['shape']}",
            hlo_gflops=art["cost_per_device"]["flops"] * art["chips"] / 1e9,
            hbm_bytes_per_chip=art["memory"]["peak_bytes_per_device"],
            chips=art["chips"])
        hosts = make_tpu_hosts(args.hosts, device=dev)
        vms = B.build_fleet([B.VmSpec(count=args.vms, pes=1, mips=197e6,
                                      ram=prof.hbm_gb_per_chip * 1024 + 1,
                                      size=100.0)], device=dev)
        cl = cloudlets_from_profile(prof, args.vms,
                                    requests_per_vm=args.waves,
                                    period=args.wave_period, device=dev)
        print(f"[simulate] LM fleet: {prof.name}, "
              f"{prof.length_mi/1e6:.1f} TFLOP/request")
    else:
        hosts = S.make_uniform_hosts(args.hosts, device=dev)
        vms = B.build_fleet([B.VmSpec(count=args.vms, pes=1, mips=1000.0,
                                      ram=512.0, bw=10.0, size=1000.0)],
                            device=dev)
        cl = B.build_waves(args.vms, B.WaveSpec(
            waves=args.waves, length_mi=args.task_mi,
            period=args.wave_period), device=dev)
    dc = S.make_datacenter(
        hosts, vms, cl, vm_policy=pol[args.vm_policy],
        task_policy=pol[args.task_policy], reserve_pes=True,
        rates=S.make_market(args.cpu_rate, 0.001, 0.0001, 0.002,
                            device=dev), device=dev)

    max_steps = 8 * args.vms * args.waves + 64
    if args.trace:
        out, trace = run_trace(dc, num_steps=args.trace)
        t, done = completion_curve(trace)
        for i in range(0, len(t), max(len(t) // 20, 1)):
            print(f"[simulate] t={t[i]:10.1f}s completed={done[i]}")
        print("[simulate]", summarize_trace(trace))
    else:
        out = run(dc, max_steps=max_steps)

    rep = B.collect(out)
    print(f"[simulate] submitted={int(rep.n_submitted)} "
          f"completed={int(rep.n_completed)} failed={int(rep.n_failed)}")
    print(f"[simulate] makespan={float(rep.makespan):.1f}s "
          f"mean_response={float(rep.mean_response):.1f}s "
          f"p99={float(rep.p99_response):.1f}s "
          f"mean_exec={float(rep.mean_exec):.1f}s")
    print(f"[simulate] cost: total=${float(rep.total_cost):.2f} "
          f"(cpu ${float(rep.cpu_cost):.2f}, mem ${float(rep.mem_cost):.2f},"
          f" sto ${float(rep.storage_cost):.2f}, "
          f"bw ${float(rep.bw_cost):.2f})")
    return out, rep


if __name__ == "__main__":
    main()
