#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA device and check it.

    python3 chip_smoke.py        (from the root of a checkout)

Phases, each printing its own lines; any failed check raises and the
script exits non-zero:

  1. header: the card (nvidia-smi name and power limit), torch and CUDA
     versions, and the build of every kernel from the checkout's sources;
  2. each kernel against its plain PyTorch version on the card, on edge
     tiles and at the main path's shapes, and timed there; then a small
     random scenario runs on the card and on the CPU (the plain kernel)
     and must agree;
  3. the paper's §5 experiment at its 10,000 hosts, both task policies,
     against the closed-form answers;
  4. the paper's largest datacenter: 100,000 hosts, 50,000 VMs, 500,000
     cloudlets, both task policies, the same closed-form checks per wave
     and per host, with wall time, events/s and device bytes.

Phases 3 and 4 are the main path: every kernel's launch count is set to
0 just before phase 3 and read just after phase 4.  The next-to-last
line is the kernels' JSON record, the last the device's.  Without a CUDA
device, or outside a checkout, the script fails before printing either.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM float32, outside tensor cores
RTOL = ATOL = 1e-6              # tests/test_simstep_parity.py's tolerance

# JAX engine's §5 answers (BENCH_policies.json fig8_fig9 resp_by_wave)
SPACE_RESP = [1200.0 + 600.0 * w for w in range(10)]
TIME_RESP = [2200.0, 4823.5713, 6623.5713, 7423.5713, 7823.5713, 7973.5713,
             7853.5713, 7553.5713, 7125.0, 6600.0]


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def device_ms(fn, reps=200):
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph and replayed, so host overhead is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def eager_ms(fn, reps=200):
    """Milliseconds per eager call (host dispatch included)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_tile(seed, v, k, device):
    """test_simstep_parity's tile: drained slots, an all-idle row, a
    zero-capacity row, a row with more PEs than slots."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    rem = rng.uniform(0.0, 5000.0, (v, k)).astype(np.float32)
    rem[rng.uniform(size=(v, k)) < 0.15] = 0.0
    run = rng.uniform(size=(v, k)) < 0.7
    cap = rng.uniform(100.0, 2000.0, v).astype(np.float32)
    pes = rng.integers(1, 4, v).astype(np.float32)
    rows = rng.permutation(v)
    run[rows[0]] = False
    cap[rows[min(1, v - 1)]] = 0.0
    pes[rows[-1]] = k + rng.integers(1, 5)
    return [torch.from_numpy(a).to(device) for a in (rem, run, cap, pes)]


def phase_kernels(device):
    """Phase 2: simstep against its plain version; returns its record
    (without the main path's launch count)."""
    import torch
    from repro_torch.kernels.simstep import simstep, simstep_ref

    shapes = [(8, 16), (13, 8), (3, 128), (32, 4), (7, 33), (1000, 300),
              (50, 10), (50000, 10)]
    worst, cases, bitwise = 0.0, 0, 0
    for v, k in shapes:
        for seed in range(2):
            tile = random_tile(seed, v, k, device)
            for policy in (0, 1):
                pol = torch.tensor(policy, dtype=torch.int32, device=device)
                got = simstep(*tile, pol)
                want = simstep_ref(*tile, pol)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
                    worst = max(worst, float((g - w).abs().max()))
                cases += 1
                bitwise += all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"[kernels] simstep vs plain version: {cases} tiles, both policies,"
          f" rtol={RTOL} atol={ATOL}: max_abs_err={worst!r}, bitwise equal "
          f"on {bitwise}/{cases}")

    record = None
    for v, k in ((50, 10), (50000, 10)):
        tile = random_tile(0, v, k, device)
        pol = torch.tensor(1, dtype=torch.int32, device=device)
        ms = device_ms(lambda: simstep(*tile, pol))
        plain_ms = device_ms(lambda: simstep_ref(*tile, pol))
        call_ms = eager_ms(lambda: simstep(*tile, pol))
        moved = v * k * (4 + 1 + 4) + v * (4 + 4 + 4) + 4
        ops = v * k * 12
        bound_ms = max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        bound_by = ("bytes" if moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
                    else "operations")
        print(f"[kernels] simstep [{v},{k}]: kernel {ms!r} ms (device, "
              f"graph replay), eager call {call_ms!r} ms, plain version "
              f"{plain_ms!r} ms, bound {bound_ms!r} ms ({moved} bytes, "
              f"{bound_by}), library call: none")
        record = {"name": "simstep", "route": "cuda",
                  "source": "src/repro_torch/kernels/simstep/csrc/simstep.cu",
                  "replaces": "src/repro/kernels/simstep/simstep.py:49",
                  "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": None}
    return record


def section5(n_hosts, n_vms, policy, device):
    """The §5 scenario: paper hosts (1 PE @1000 MIPS, 1 GB, 2 TB) with a
    100 W idle / 200 W peak linear power model, ``n_vms`` 1-PE VMs, ten
    waves of 1.2M MI cloudlets 600 s apart, PEs reserved."""
    from repro_torch.core import broker as B
    from repro_torch.core import state as S
    hosts = S.make_uniform_hosts(n_hosts, idle_w=100.0, peak_w=200.0,
                                 device=device)
    vms = B.build_fleet([B.VmSpec(count=n_vms, pes=1, mips=1000.0,
                                  ram=512.0, bw=10.0, size=1000.0)],
                        device=device)
    cl = B.build_waves(n_vms, B.WaveSpec(waves=10, length_mi=1_200_000.0,
                                         period=600.0), device=device)
    return S.make_datacenter(hosts, vms, cl, vm_policy=S.SPACE_SHARED,
                             task_policy=policy, reserve_pes=True,
                             rates=S.make_market(0.01, 0.001, 1e-4, 0.002,
                                                 device=device),
                             device=device)


def check_section5(final, stats, policy, n_vms, tag):
    """The closed-form §5 answers, per wave and per host."""
    import numpy as np
    from repro_torch.core import broker as B
    from repro_torch.core import state as S
    rep = B.collect(final)
    n_cl = 10 * n_vms
    check(int(rep.n_completed) == n_cl and int(rep.n_failed) == 0,
          f"{tag}: {int(rep.n_completed)}/{n_cl} done")
    check(float(rep.makespan) == 12000.0, f"{tag}: makespan "
          f"{float(rep.makespan)!r}")
    cl = final.cloudlets
    ft = cl.finish_time.double().cpu().numpy()
    st = cl.start_time.double().cpu().numpy()
    sub = cl.submit_time.double().cpu().numpy()
    wave = np.rint(sub / 600.0).astype(int)
    resp = [float((ft - sub)[wave == w].mean()) for w in range(10)]
    if policy == S.SPACE_SHARED:
        check(bool(np.all(ft - st == 1200.0)), f"{tag}: exec != 1200 s")
        check(resp == SPACE_RESP, f"{tag}: response by wave {resp}")
    else:
        err = max(abs(a - b) for a, b in zip(resp, TIME_RESP))
        check(err <= 1e-3, f"{tag}: response by wave {resp} (err {err})")
        # every VM's cloudlets are alike, so every VM gives the same answer
        per_vm = (ft - sub).reshape(n_vms, 10)
        check(bool(np.all(np.abs(per_vm - per_vm[0]) <= 1e-3)),
              f"{tag}: VMs disagree")
    energy = final.hosts.energy_j.double().cpu().numpy()
    busy = np.zeros(energy.shape[0], bool)
    busy[final.vms.host.cpu().numpy()] = True
    e_busy = np.abs(energy[busy] / 2.4e6 - 1.0).max()
    e_idle = np.abs(energy[~busy] / 1.2e6 - 1.0).max()
    check(busy.sum() == n_vms and e_busy <= 1e-5 and e_idle <= 1e-5,
          f"{tag}: energy off by {e_busy!r} (busy), {e_idle!r} (idle)")
    exec_t = ft - st
    print(f"[{tag}] {int(rep.n_completed)}/{n_cl} done, exec "
          f"{exec_t.min():.4f}-{exec_t.max():.4f} s, makespan "
          f"{float(rep.makespan)!r} s, response by wave {resp}, energy "
          f"rel err busy {e_busy:.3g} idle {e_idle:.3g}, "
          f"{stats.n_events} events in {stats.n_steps} steps, "
          f"{stats.n_blocks} host checks, bill ${float(rep.total_cost):.2f}")


def state_bytes(dc):
    import dataclasses
    import torch
    total = 0
    for f in dataclasses.fields(dc):
        v = getattr(dc, f.name)
        total += (v.numel() * v.element_size() if isinstance(v, torch.Tensor)
                  else state_bytes(v))
    return total


def phase_section5(device, card, n_hosts=10_000):
    """Phase 3: §5 at the paper's 10,000 hosts."""
    import torch
    from repro_torch.core import state as S
    from repro_torch.core.engine import run_stats
    from repro_torch.kernels.simstep import simstep

    for policy in (S.SPACE_SHARED, S.TIME_SHARED):
        dc = section5(n_hosts, 50, policy, device)
        before = simstep.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, stats = run_stats(dc, max_steps=8192)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = simstep.launches - before
        check(launched == stats.n_steps >= stats.n_events,
              f"simstep launches {launched}, steps {stats.n_steps}, events "
              f"{stats.n_events}")
        check_section5(final, stats, policy, 50, f"s5-10k-{policy}")
        print(f"[s5-10k-{policy}] wall {wall!r} s, simstep launches "
              f"{launched} ({card})")


def phase_agreement(device):
    """A small heterogeneous scenario run on the card and on the CPU (the
    plain kernel): the whole engine agrees, not only the kernel."""
    import numpy as np
    import torch
    from repro_torch.core import state as S
    from repro_torch.core.engine import run_stats

    rng = np.random.default_rng(7)
    hosts = dict(num_pes=rng.integers(1, 4, 6),
                 mips_per_pe=rng.choice([250.0, 500.0, 1000.0], 6),
                 ram=4096.0, bw=1000.0, storage=1e6, idle_w=0.1, peak_w=0.5)
    vm_pes = rng.integers(1, 3, 8)
    owners = np.repeat(np.arange(8, dtype=np.int32), rng.integers(0, 5, 8))
    lengths = np.round(rng.uniform(500, 8000, owners.size)).astype(np.float32)
    submit = np.round(rng.uniform(0, 20, owners.size), 2).astype(np.float32)
    submit = np.concatenate([np.sort(submit[owners == v]) for v in range(8)])
    vm_sub = np.round(rng.uniform(0, 5, 8), 2).astype(np.float32)
    for vp in (S.SPACE_SHARED, S.TIME_SHARED):
        for tp in (S.SPACE_SHARED, S.TIME_SHARED):
            outs = []
            for dev in (device, "cpu"):
                dc = S.make_datacenter(
                    S.make_hosts(**hosts, device=dev),
                    S.make_vms(vm_pes, 500.0, 64.0, 1.0, 10.0,
                               submit_time=vm_sub, device=dev),
                    S.make_cloudlets(owners, lengths, submit, device=dev),
                    vm_policy=vp, task_policy=tp, reserve_pes=False,
                    device=dev)
                outs.append(run_stats(dc, max_steps=512))
            (gpu, gs), (cpu, cs) = outs
            check(gs.n_events == cs.n_events, "small scenario: event counts")
            check(torch.equal(gpu.cloudlets.state.cpu(), cpu.cloudlets.state),
                  "small scenario: cloudlet states")
            check(torch.equal(gpu.vms.host.cpu(), cpu.vms.host),
                  "small scenario: placements")
            err = float((gpu.cloudlets.finish_time.cpu()
                         - cpu.cloudlets.finish_time).abs().max())
            e_err = float((gpu.hosts.energy_j.cpu()
                           - cpu.hosts.energy_j).abs().max())
            check(err <= 1e-3 and e_err <= 1e-3,
                  f"small scenario: finish err {err}, energy err {e_err}")
    print(f"[small] card == CPU on a random 6-host/8-VM/{owners.size}-cloudlet"
          f" scenario, all four policy pairs (states, placements, events "
          f"exact; times and joules within 1e-3)")


def phase_scale(device, card, n_hosts=100_000, n_vms=50_000):
    """Phase 4: the paper's largest datacenter."""
    import torch
    from repro_torch.core import state as S
    from repro_torch.core.engine import run_stats
    from repro_torch.core.provisioning import provision_pending
    from repro_torch.kernels.simstep import simstep

    for policy in (S.SPACE_SHARED, S.TIME_SHARED):
        dc = section5(n_hosts, n_vms, policy, device)
        nbytes = state_bytes(dc)
        before = simstep.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, stats = run_stats(dc, max_steps=8192)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = simstep.launches - before
        check(launched == stats.n_steps >= stats.n_events,
              f"simstep launches {launched}, steps {stats.n_steps}")
        tag = f"s5-100k-{policy}"
        check_section5(final, stats, policy, n_vms, tag)
        # the two parts of the run, timed apart: placing the fleet, then
        # stepping the placed state to quiescence
        t0 = time.perf_counter()
        placed = provision_pending(dc)
        torch.cuda.synchronize()
        prov = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_stats(placed, max_steps=8192)
        torch.cuda.synchronize()
        stepping = time.perf_counter() - t0
        print(f"[{tag}] {n_hosts} hosts, {n_vms} VMs, {10 * n_vms} "
              f"cloudlets: wall {wall!r} s, {stats.n_events} events, "
              f"{stats.n_events / wall!r} events/s; timed apart: "
              f"provisioning {prov!r} s, stepping {stepping!r} s; state "
              f"{nbytes} bytes on the device, peak allocated "
              f"{torch.cuda.max_memory_allocated()} bytes ({card})")


def phase_profile(device, card):
    """Where a §5 run's device time goes: profiler traces of the
    time-shared runs at both scales (after the main path's counts are
    read).  Device busy share = kernel and copy time over wall time."""
    import torch
    from repro_torch.core import state as S
    from repro_torch.core.engine import run_stats
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    for n_hosts, n_vms in ((10_000, 50), (100_000, 50_000)):
        dc = section5(n_hosts, n_vms, S.TIME_SHARED, device)
        run_stats(dc, max_steps=8192)           # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_stats(dc, max_steps=8192)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # kernels and copies only: the CPU ops that launched them carry
        # the same device time again
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
        tag = f"[profile] s5 {n_hosts} hosts time-shared"
        if not events:
            print(f"{tag}: the profiler showed no device time: not measured")
            continue
        busy = sum(dev_us(e) for e in events) / 1e6
        top = sorted(events, key=dev_us, reverse=True)[:5]
        print(f"{tag}: wall {wall!r} s under the profiler, device busy "
              f"{busy!r} s ({busy / wall:.4f} of wall), "
              f"{sum(e.count for e in events)} device ops; top: "
              + "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.3f} ms "
                          f"x{e.count}" for e in top) + f" ({card})")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.simstep import simstep

    device = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"[header] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[header] kernels built in {time.perf_counter() - t0!r} s: "
          f"{built}")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[header] {name}: {line.strip()}")

    record = phase_kernels(device)
    phase_agreement(device)

    simstep.launches = 0        # the main path: phases 3 and 4
    phase_section5(device, card)
    phase_scale(device, card)
    record["launches"] = simstep.launches
    check(record["launches"] > 0, "simstep never launched on the main path")
    phase_profile(device, card)

    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
