"""Closed-loop elasticity studies (``repro.core.experiments``' elasticity
half, in PyTorch): the autoscaler policy search reduced to a cost / SLA
/ energy Pareto front against a static fleet.

``run_elasticity_study`` runs every (scenario, autoscaler point) cell in
one elastic batch (``sweep.run_policy_search``) and the static baseline
in another (``sweep.run_batch``); the reductions are per-lane sums on
the device and a NumPy Pareto mask on the host.  When the batch carries
an enabled metrics plane, each point also gains response percentiles
(``telemetry.hist_percentile``) and its earliest SLA breach.

The federation half (``Provider``, ``build_study``, ``run_study``)
belongs to the multi-device and federation slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine, sweep, telemetry
from repro_torch.core import state as S
from repro_torch.core.provisioning import FIRST_FIT

__all__ = ["sla_violations", "pareto_front", "ElasticityStudy",
           "run_elasticity_study"]


def sla_violations(final: S.DatacenterState, *, factor: float = 2.0,
                   include_unfinished: bool = False) -> torch.Tensor:
    """i32[...] — completed cloudlets whose response exceeded ``factor``
    times their dedicated service time (``length / req_mips`` of their
    VM), over the trailing cloudlet axis.  ``include_unfinished`` also
    counts cloudlets still ``CL_CREATED`` (work stranded on slots the
    autoscaler never brought up)."""
    cl, vms = final.cloudlets, final.vms
    nv = vms.req_mips.shape[-1]
    owner = torch.clamp(cl.vm, 0, nv - 1).long()
    mips = torch.gather(vms.req_mips, -1, owner)
    ideal = cl.length / torch.clamp(mips, min=1e-30)
    done = cl.state == S.CL_DONE
    resp = cl.finish_time - cl.submit_time
    viol = done & (resp > float(np.float32(factor)) * ideal)
    if include_unfinished:
        viol = viol | (cl.state == S.CL_CREATED)
    return viol.sum(dim=-1, dtype=torch.int32)


def pareto_front(points) -> np.ndarray:
    """bool[N] — nondominated rows of an [N, K] objective table, every
    objective minimised: a row is dominated when another row is <=
    everywhere and < somewhere; duplicates of a front point stay on it."""
    pts = np.asarray(points, np.float64)
    if pts.ndim != 2:
        raise ValueError(f"expected [N, K] objectives, got {pts.shape}")
    n = pts.shape[0]
    mask = np.ones(n, bool)
    for i in range(n):
        dominated = (np.all(pts <= pts[i], axis=1)
                     & np.any(pts < pts[i], axis=1))
        if dominated.any():
            mask[i] = False
    return mask


class ElasticityStudy(NamedTuple):
    """``run_elasticity_study``'s results: P policy points, B scenarios.
    ``cost`` is spot spend plus the market bill over the scenarios;
    ``pareto`` marks the nondominated (cost, SLA violations, energy)
    points.  The latency and breach columns are NaN when probes are
    off."""
    grid: sweep.PolicyGrid
    final: S.DatacenterState      # final states, leaves [P, B, ...]
    summary: sweep.SweepSummary   # per-cell scalars, leaves [P, B]
    sla: torch.Tensor             # i32[P] SLA violations over scenarios
    cost: torch.Tensor            # f32[P] spot + market $ over scenarios
    energy_j: torch.Tensor        # f32[P] joules over scenarios
    pareto: np.ndarray            # bool[P] nondominated points
    static_summary: sweep.SweepSummary  # static baseline, leaves [B]
    static_sla: torch.Tensor      # i32[] baseline SLA violations
    static_cost: torch.Tensor     # f32[] baseline spot + market $
    static_energy_j: torch.Tensor  # f32[] baseline joules
    latency_p50: np.ndarray       # f64[P] response p50 over scenarios
    latency_p95: np.ndarray       # f64[P] response p95
    first_breach_t: np.ndarray    # f64[P] earliest SLA breach (NaN: none)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def run_elasticity_study(batch: S.DatacenterState, grid: sweep.PolicyGrid,
                         *, static_batch: S.DatacenterState | None = None,
                         sla_factor: float = 2.0,
                         include_unfinished: bool = True,
                         max_steps: int = 1_000_000,
                         provision_policy: int = FIRST_FIT
                         ) -> ElasticityStudy:
    """Policy search, then the Pareto front against a static fleet.

    Every (scenario, point) cell runs in one elastic batch; the baseline
    is ``static_batch`` (default: ``batch`` with the scaler disabled and
    its spot accrual live, so a static fleet pays the spot price for
    every alive VM all run long)."""
    final = sweep.run_policy_search(batch, grid, max_steps=max_steps,
                                    provision_policy=provision_policy)
    summary = sweep.summarize_batch(final)
    sla = sla_violations(final, factor=sla_factor,
                         include_unfinished=include_unfinished).sum(
        dim=-1, dtype=torch.int32)
    cost = (summary.total_cost + summary.spot_cost).sum(dim=-1)
    energy = summary.energy_j.sum(dim=-1)
    front = pareto_front(np.stack([_np(cost).astype(np.float64),
                                   _np(sla).astype(np.float64),
                                   _np(energy).astype(np.float64)], axis=1))
    n_pol = int(cost.shape[0])
    if engine.wants_probes(batch):
        m = final.metrics
        hist = _np(m.hist_response).astype(np.int64)        # [P, B, NB]
        edges = _np(m.edges).reshape(hist.shape[:2] + (-1,))[0, 0]
        lat50 = np.array([telemetry.hist_percentile(hist[p].sum(0), edges,
                                                    50)
                          for p in range(n_pol)])
        lat95 = np.array([telemetry.hist_percentile(hist[p].sum(0), edges,
                                                    95)
                          for p in range(n_pol)])
        fb = _np(m.first_breach_t).astype(np.float64).min(axis=-1)
        breach_t = np.where(fb >= telemetry._METRICS_INF, np.nan, fb)
    else:
        lat50 = np.full(n_pol, np.nan)
        lat95 = np.full(n_pol, np.nan)
        breach_t = np.full(n_pol, np.nan)
    if static_batch is None:
        static_batch = dataclasses.replace(
            batch, scaler=dataclasses.replace(
                batch.scaler,
                enabled=torch.zeros_like(batch.scaler.enabled)))
    sfinal = sweep.run_batch(static_batch, max_steps=max_steps,
                             provision_policy=provision_policy)
    ssum = sweep.summarize_batch(sfinal)
    return ElasticityStudy(
        grid=grid, final=final, summary=summary,
        sla=sla, cost=cost, energy_j=energy, pareto=front,
        static_summary=ssum,
        static_sla=sla_violations(
            sfinal, factor=sla_factor,
            include_unfinished=include_unfinished).sum(dtype=torch.int32),
        static_cost=(ssum.total_cost + ssum.spot_cost).sum(),
        static_energy_j=ssum.energy_j.sum(),
        latency_p50=lat50,
        latency_p95=lat95,
        first_breach_t=breach_t,
    )
