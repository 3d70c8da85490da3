"""Policy sweep on the PyTorch port: the 2x2 scheduling matrix x
Monte-Carlo Poisson arrivals, fused into ONE batched simulation (CloudSim
would run 4xN JVM processes for this).

    PYTHONPATH=src python examples/torch_policy_sweep.py [--device cpu]

The arrivals are drawn with NumPy from seeds 0..15 (the JAX example
draws them with ``jax.random``, so its numbers differ).  Runs on the CUDA
device unless ``--device`` says otherwise.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import broker as B
from repro_torch.core import state as S
from repro_torch.core import sweep

N_SEEDS = 16
N_VMS, MAX_PER_VM, RATE, HORIZON = 24, 8, 0.01, 900.0

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

hosts = S.make_uniform_hosts(64, pes=2, device=dev)
vms = B.build_fleet([B.VmSpec(count=N_VMS, pes=1)], device=dev)


def scenario(seed):
    """A Poisson process per VM: exponential gaps, arrivals past the
    horizon parked as empty slots."""
    gaps = np.random.default_rng(seed).exponential(
        1.0 / RATE, (N_VMS, MAX_PER_VM)).astype(np.float32)
    submit = np.cumsum(gaps, axis=1).reshape(-1)
    cl = S.make_cloudlets(np.repeat(np.arange(N_VMS), MAX_PER_VM),
                          120_000.0, submit, device=dev)
    alive = torch.from_numpy(submit <= HORIZON).to(dev)
    cl = dataclasses.replace(
        cl, state=torch.where(alive, cl.state, S.CL_EMPTY),
        remaining=torch.where(alive, cl.remaining, 0.0))
    return S.make_datacenter(hosts, vms, cl, reserve_pes=False, device=dev)


batch = sweep.stack_scenarios([scenario(s) for s in range(N_SEEDS)])
grid = sweep.run_grid(batch, *sweep.policy_grid(device=dev), max_steps=1024)

names = ["space/space", "space/time", "time/space", "time/time"]
print(f"{'policy (vm/task)':>16} | mean response (s) | p99 (s)")
for p, n in enumerate(names):
    reps = [B.collect(S.map_tensors(lambda t: t[p, b], grid))
            for b in range(N_SEEDS)]
    mean = np.nanmean([float(r.mean_response) for r in reps])
    p99 = np.nanmean([float(r.p99_response) for r in reps])
    print(f"{n:>16} | {mean:17.1f} | {p99:7.1f}")
print(f"\n({4 * N_SEEDS} full simulations in one batched run)")
