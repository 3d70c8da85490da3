"""Straggler mitigation for synchronous training, validated with the
paper's own simulator (``repro.ft.straggler`` on the port).

A synchronous SGD step over N workers is a wave of N equal cloudlets, one
per worker VM; the step time is set by the slowest participant.  A fleet
with a fraction of degraded hosts (reduced MIPS: thermal throttling,
shared tenancy) runs under one of three mitigation policies:

  none    the barrier waits for all N (step = max finish)
  drop    proceed after the fastest k of N complete (gradient dropping;
          step = k-th order statistic)
  backup  every work unit is duplicated on a spare host; the barrier
          takes min(primary, backup) per unit (MapReduce backup tasks)

The step times come from running the DES engine over the fleet (level 2
through the simstep kernel on the card), then NumPy over the finish
times, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import state as S
from repro_torch.core.engine import RunStats, run_stats
from repro_torch.core.provisioning import provision_pending
from repro_torch.device import resolve_device

__all__ = ["simulate_sync_training", "StragglerReport"]


@dataclasses.dataclass
class StragglerReport:
    policy: str
    step_times: np.ndarray         # [steps]
    mean_step: float
    p99_step: float
    slowdown_vs_ideal: float       # mean / (work / healthy MIPS)
    stats: RunStats | None = None  # what the engine's run did


def _degrade(dc, n_workers: int, slow_frac: float, slow_factor: float,
             base_mips: float, seed: int):
    """Throttle a random subset of hosts AFTER placement: stragglers are a
    runtime phenomenon, not an admission one (the §4 provisioner rejects
    VMs whose requested MIPS a host cannot nominally offer)."""
    rng = np.random.default_rng(seed)
    n_slow = int(round(slow_frac * n_workers))
    slow_idx = rng.choice(n_workers, n_slow, replace=False)
    mips = dc.hosts.mips_per_pe.cpu().numpy().copy()
    mips[slow_idx] = base_mips / slow_factor
    return dataclasses.replace(
        dc, hosts=dataclasses.replace(
            dc.hosts, mips_per_pe=torch.from_numpy(mips).to(dc.time.device)))


def simulate_sync_training(*, n_workers: int = 64, steps: int = 20,
                           work_mi: float = 60_000.0,
                           base_mips: float = 1000.0,
                           slow_frac: float = 0.05,
                           slow_factor: float = 4.0,
                           policy: str = "none",
                           drop_k: int | None = None,
                           seed: int = 0, device=None) -> StragglerReport:
    """Step times of ``steps`` synchronous steps over ``n_workers``
    (plus as many spares under ``backup``), on ``device`` (the card
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    spares = n_workers if policy == "backup" else 0
    n = n_workers + spares
    hosts = S.make_hosts(np.ones(n, np.int64),
                         np.full(n, base_mips, np.float32),
                         4096.0, 1000.0, 1e9, device=dev)
    vms = S.make_vms([1] * n, base_mips, 64.0, 1.0, 10.0, device=dev)
    # each VM gets `steps` cloudlets, all submitted at t=0: each VM holds
    # a dedicated PE, so wave k finishes at k unit times
    cl = S.make_cloudlets(
        np.repeat(np.arange(n, dtype=np.int32), steps),
        work_mi, np.zeros(n * steps, np.float32), device=dev)
    dc = S.make_datacenter(hosts, vms, cl, vm_policy=S.SPACE_SHARED,
                           task_policy=S.SPACE_SHARED, reserve_pes=True,
                           device=dev)
    dc = provision_pending(dc)                      # place at nominal MIPS
    dc = _degrade(dc, n_workers, slow_frac, slow_factor, base_mips, seed)
    out, stats = run_stats(dc, max_steps=4 * n * steps + 64)
    ft = out.cloudlets.finish_time.cpu().numpy().reshape(n, steps)
    # per-worker per-step durations (a dedicated PE: uniform spacing)
    durations = np.diff(np.concatenate(
        [np.zeros((n, 1), np.float32), ft], axis=1), axis=1)

    prim = durations[:n_workers]
    if policy == "none":
        step_times = prim.max(axis=0)
    elif policy == "drop":
        k = drop_k or int(0.95 * n_workers)
        step_times = np.sort(prim, axis=0)[k - 1]
    elif policy == "backup":
        paired = np.minimum(prim, durations[n_workers:])
        step_times = paired.max(axis=0)
    else:
        raise ValueError(policy)

    ideal = work_mi / base_mips
    return StragglerReport(
        policy=policy,
        step_times=step_times,
        mean_step=float(step_times.mean()),
        p99_step=float(np.percentile(step_times, 99)),
        slowdown_vs_ideal=float(step_times.mean() / ideal),
        stats=stats,
    )
