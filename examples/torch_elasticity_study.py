"""Elasticity study on the PyTorch port: SLA-driven autoscaling against a
static fleet on diurnal load (``examples/elasticity_study.py``'s
configurations, run through ``repro_torch``).

  1. Policy search: three diurnal days through a watermark x cooldown x
     price-sensitivity grid in one elastic batch
     (``sweep.run_policy_search``), reduced to a cost / SLA / energy
     Pareto front against a peak-provisioned static fleet
     (``experiments.run_elasticity_study``).
  2. Scale profile: the cheapest policy that beats the static fleet,
     replayed with a trace (``engine.run_trace``): the fleet grows into
     the mid-day peak and drains back (``telemetry.fleet_timeline``).
  3. Streamed lane: the same control loop on a windowed arrival lane
     (``engine.run_stream``).

The days are drawn on the host from NumPy seeds, so the scenarios are
the JAX study's exactly and the two print the same table.

    PYTHONPATH=src python examples/torch_elasticity_study.py [--device cpu]

Runs on the CUDA device unless ``--device`` says otherwise.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import experiments as X
from repro_torch.core import state as S
from repro_torch.core import sweep, telemetry, workloads
from repro_torch.core.engine import run_stream, run_trace
from repro_torch.data.synthetic import thinned_arrivals

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

DAY = 120.0          # one compressed "day" (seconds)
N_VMS = 12           # VM slots = the scale-out ceiling
ALIVE0 = 3           # overnight fleet the autoscaler starts from
SLA_FACTOR = 30.0    # allowed response stretch over dedicated service time


def diurnal_scenario(seed, *, alive, spot=True):
    """One diurnal day as a dense elastic lane: arrivals thinned from the
    diurnal rate and routed round-robin over as many slots as the
    current rate warrants, grouped by VM; ``alive`` slots start
    submitted, the rest are latent capacity; a spot track that peaks
    mid-day."""
    rng = np.random.default_rng(seed)
    rate = lambda t: workloads.diurnal_rate(t, base=0.4, peak=6.0,
                                            period=DAY)
    times = thinned_arrivals(rng, rate, DAY, 6.0).astype(np.float32)
    n = times.shape[0]
    svc = 0.9                       # mean service seconds at 1000 MIPS
    target = np.clip(np.ceil(rate(times) * svc / 0.6),
                     alive, N_VMS).astype(np.int64)
    vm_rr = (np.arange(n) % target).astype(np.int32)
    order = np.argsort(vm_rr, kind="stable")
    vm, sub = vm_rr[order], times[order]
    lens = rng.uniform(300.0, 1500.0, n).astype(np.float32)

    hosts = S.make_uniform_hosts(4, pes=4, mips=1000.0, ram=8192.0,
                                 bw=1000.0, storage=1e6,
                                 idle_w=93.7, peak_w=135.0, device=dev)
    vms = S.make_vms([1] * N_VMS, [1000.0] * N_VMS, [512.0] * N_VMS,
                     [100.0] * N_VMS, [1000.0] * N_VMS, device=dev)
    st = np.full(N_VMS, S.VM_EMPTY, np.int32)
    st[:alive] = S.VM_PENDING
    vms = dataclasses.replace(vms, state=torch.from_numpy(st).to(dev))
    kw = {}
    if spot:
        kw = dict(spot_t=[0.0, 0.25 * DAY, 0.5 * DAY, 0.75 * DAY],
                  spot_price=[0.010, 0.025, 0.040, 0.015])
    scaler = S.make_autoscaler(util_high=0.75, util_low=0.25, cooldown=2.0,
                               min_fleet=ALIVE0, max_fleet=N_VMS,
                               scale_step=2, device=dev, **kw)
    return S.make_datacenter(hosts, vms,
                             S.make_cloudlets(vm, lens, sub, device=dev),
                             vm_policy=S.SPACE_SHARED,
                             task_policy=S.SPACE_SHARED, scaler=scaler,
                             device=dev)


# ---------------------------------------------------------------------------
# 1. Policy search -> Pareto front vs. the peak-provisioned static fleet
# ---------------------------------------------------------------------------
SEEDS = (7, 11, 13)
days = [diurnal_scenario(s, alive=ALIVE0) for s in SEEDS]
batch = sweep.stack_scenarios(days)
full = torch.full((N_VMS,), S.VM_PENDING, dtype=torch.int32, device=dev)
off = torch.zeros((), dtype=torch.int32, device=dev)
static = sweep.stack_scenarios([
    dataclasses.replace(d, vms=dataclasses.replace(d.vms, state=full),
                        scaler=dataclasses.replace(d.scaler, enabled=off))
    for d in days])

grid = sweep.policy_points(util_highs=(0.6, 0.75, 0.9),
                           util_lows=(0.2, 0.35), cooldowns=(1.0, 4.0),
                           price_sensitivities=(0.0, 0.03), device=dev)
study = X.run_elasticity_study(batch, grid, static_batch=static,
                               sla_factor=SLA_FACTOR, max_steps=65_536)

P = study.cost.shape[0]
s_cost = float(study.static_cost)
s_sla = int(study.static_sla)
s_energy = float(study.static_energy_j)
print(f"# policy search: {P} autoscaler points x {len(SEEDS)} diurnal days"
      f" in one elastic batch")
print(f"# static fleet ({N_VMS} VMs all day): cost=${s_cost:.2f}"
      f" sla_violations={s_sla} energy={s_energy / 1e3:.1f}kJ")
print("util_high,util_low,cooldown_s,price_sens,cost_$,sla,energy_kJ,"
      "scale_ups,scale_downs,pareto,beats_static")
dominating = []
for p in range(P):
    cost = float(study.cost[p])
    sla = int(study.sla[p])
    ups = int(study.summary.n_scale_up[p].sum())
    downs = int(study.summary.n_scale_down[p].sum())
    beats = cost < s_cost and sla <= s_sla
    if beats:
        dominating.append(p)
    print(f"{float(grid.util_high[p]):.2f},{float(grid.util_low[p]):.2f},"
          f"{float(grid.cooldown[p]):.0f},"
          f"{float(grid.price_sensitivity[p]):.3f},"
          f"{cost:.2f},{sla},{float(study.energy_j[p]) / 1e3:.1f},"
          f"{ups},{downs},{bool(study.pareto[p])},{beats}")

assert dominating, "no autoscaling policy dominated the static fleet"
best = min(dominating, key=lambda p: float(study.cost[p]))
print(f"\n# {len(dominating)}/{P} policies strictly beat the static fleet on"
      f" cost at equal-or-better SLA; best: util_high="
      f"{float(grid.util_high[best]):.2f} util_low="
      f"{float(grid.util_low[best]):.2f} cooldown="
      f"{float(grid.cooldown[best]):.0f}s -> ${float(study.cost[best]):.2f}"
      f" ({(1.0 - float(study.cost[best]) / s_cost) * 100.0:.0f}% saved)")

# ---------------------------------------------------------------------------
# 2. The best policy's scale profile (fleet + spot-spend timelines)
# ---------------------------------------------------------------------------
dc = days[0]
dc = dataclasses.replace(dc, scaler=dataclasses.replace(
    dc.scaler, util_high=grid.util_high[best].clone(),
    util_low=grid.util_low[best].clone(),
    cooldown=grid.cooldown[best].clone(),
    scale_step=grid.scale_step[best].clone(),
    price_sensitivity=grid.price_sensitivity[best].clone()))
out, trace = run_trace(dc, num_steps=4096)
t, fleet = telemetry.fleet_timeline(trace)
_, spend = telemetry.spot_cost_timeline(trace)
print(f"\n# scale profile, day seed {SEEDS[0]} (fleet over the day;"
      f" {int(out.scaler.up_count)} ups, {int(out.scaler.down_count)} downs):")
for m in np.linspace(0.0, float(t[-1]), 13)[1:]:
    i = int(np.searchsorted(t, m, side="right")) - 1
    if i < 0:
        continue
    print(f"  t={m:5.1f}s  fleet={int(fleet[i]):2d} "
          f"{'#' * int(fleet[i])}  spot=${float(spend[i]):.2f}")

# ---------------------------------------------------------------------------
# 3. The same loop on a streamed (windowed) lane
# ---------------------------------------------------------------------------
stream = workloads.diurnal_stream(21, ALIVE0, base_rate=0.4, peak_rate=4.0,
                                  period=DAY, horizon=DAY,
                                  length_mi=(300.0, 1500.0), chunk=64,
                                  device=dev)
base = diurnal_scenario(23, alive=ALIVE0)
sdc = dataclasses.replace(base, cloudlets=S.make_window(16, device=dev))
s_out, s_stats, _ = run_stream(sdc, stream)
print(f"\n# streamed lane (window 16, scaler on): "
      f"retired={int(s_stats.stats.n_retired)} "
      f"ups={int(s_out.scaler.up_count)} downs={int(s_out.scaler.down_count)}"
      f" spot=${float(s_out.scaler.spot_cost):.2f}"
      f" makespan={float(s_stats.stats.makespan):.0f}s")
