"""The in-run metrics plane (``repro.core.metrics`` in PyTorch).

``MetricsState`` rides on every ``DatacenterState``.  The default plane
(``no_metrics``) is inert and the engine never touches it; an enabled
plane (``make_metrics``) is filled by the engine's commit, O(K) a lane,
never O(events):

* bucketed timelines — K fixed time buckets over a build-time
  ``horizon`` accumulating time-weighted utilization, watts, fleet,
  backlog and flows (``accrue_interval``; a leap iteration books its
  interval with the same arithmetic as a full step, so the plane is the
  same bits with the leap on or off),
* histograms — NB fixed log-spaced bins of cloudlet response, exec and
  wait times, filled once at retirement (``fill_retirement``; integer
  scatters, exact in any order),
* counters — SLA breaches and the first breach's time, peak backlog,
  per-host busy seconds.

Every function takes a plane whose leaves may carry leading lane axes
(``[..., K]``, ``[..., NB]``, scalars ``[...]``), the layout of a
batch; the other arguments carry the same leading axes.  All booked
terms are >= 0 and gate to +0.0 on a disabled plane or an empty
interval, so a quiesced step stays a bit-exact fixed point.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.spans import span

__all__ = ["MetricsState", "make_metrics", "no_metrics", "metrics_edges",
           "bucket_overlap", "hist_index", "accrue_interval",
           "fill_retirement"]

INF = 1e30


@dataclasses.dataclass
class MetricsState:
    """Per-lane metrics plane; ``enabled == 0`` is inert."""
    enabled: torch.Tensor         # i32[]
    horizon: torch.Tensor         # f32[]   bucket span end (s)
    sla_factor: torch.Tensor      # f32[]   response bound multiplier
    edges: torch.Tensor           # f32[NB+1] histogram bin edges
    bucket_dt: torch.Tensor       # f32[K]
    bucket_util: torch.Tensor     # f32[K]
    bucket_watts: torch.Tensor    # f32[K]
    bucket_fleet: torch.Tensor    # f32[K]
    bucket_backlog: torch.Tensor  # f32[K]
    bucket_flows: torch.Tensor    # f32[K]
    hist_response: torch.Tensor   # i32[NB]
    hist_exec: torch.Tensor       # i32[NB]
    hist_wait: torch.Tensor       # i32[NB]
    sla_breaches: torch.Tensor    # i32[]
    first_breach_t: torch.Tensor  # f32[]
    peak_backlog: torch.Tensor    # i32[]
    host_busy_s: torch.Tensor     # f32[H]


def metrics_edges(bins: int, t_min: float, t_max: float) -> np.ndarray:
    """f32[bins+1] histogram edges: [0, geomspace(t_min..t_max), INF],
    built in f64 and cast once (the JAX package's and the oracle's
    edges, bit for bit)."""
    if bins < 2:
        raise ValueError("metrics histograms need >= 2 bins")
    interior = np.geomspace(float(t_min), float(t_max), bins - 1)
    return np.concatenate([[0.0], interior, [1e30]]).astype(np.float32)


def _plane(n_hosts: int, *, enabled: int, horizon: float, sla_factor: float,
           edges: np.ndarray, buckets: int, device) -> MetricsState:
    dev = resolve_device(device)
    f32 = lambda shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    i32 = lambda shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    bins = edges.shape[0] - 1
    with span("sync.build.copy"):
        horizon = torch.tensor(np.float32(horizon), device=dev)
    with span("sync.build.copy"):
        sla_factor = torch.tensor(np.float32(sla_factor), device=dev)
    with span("sync.build.copy"):
        edges = torch.from_numpy(edges).to(dev)
    return MetricsState(
        enabled=torch.full((), enabled, dtype=torch.int32, device=dev),
        horizon=horizon, sla_factor=sla_factor, edges=edges,
        bucket_dt=f32((buckets,)), bucket_util=f32((buckets,)),
        bucket_watts=f32((buckets,)), bucket_fleet=f32((buckets,)),
        bucket_backlog=f32((buckets,)), bucket_flows=f32((buckets,)),
        hist_response=i32((bins,)), hist_exec=i32((bins,)),
        hist_wait=i32((bins,)),
        sla_breaches=i32(()),
        first_breach_t=torch.full((), INF, dtype=torch.float32, device=dev),
        peak_backlog=i32(()),
        host_busy_s=f32((n_hosts,)))


def make_metrics(n_hosts: int, *, horizon: float, buckets: int = 32,
                 bins: int = 24, t_min: float = 1e-2, t_max: float = 1e4,
                 sla_factor: float = 0.0, device=None) -> MetricsState:
    """Enabled plane: K=``buckets`` timeline rows over ``[0, horizon)``
    (the last bucket absorbs overflow) and NB=``bins`` log-spaced bins
    over ``[t_min, t_max]`` with an underflow and an overflow bin.

    ``sla_factor > 0`` arms the SLA watermark: a retirement breaches when
    ``finish - submit > sla_factor * length / req_mips(vm)``.  Lanes
    stacked into one batch must share ``buckets`` and ``bins``."""
    if buckets < 1:
        raise ValueError("metrics timelines need >= 1 bucket")
    if not horizon > 0.0:
        raise ValueError("metrics horizon must be > 0")
    return _plane(n_hosts, enabled=1, horizon=horizon, sla_factor=sla_factor,
                  edges=metrics_edges(bins, t_min, t_max), buckets=buckets,
                  device=device)


def no_metrics(n_hosts: int, *, device=None) -> MetricsState:
    """Inert plane (enabled=0, K=1, NB=2) — the default on every state."""
    return _plane(n_hosts, enabled=0, horizon=0.0, sla_factor=0.0,
                  edges=np.asarray([0.0, 1.0, INF], np.float32), buckets=1,
                  device=device)


def bucket_overlap(m: MetricsState, t0, t1, gate) -> torch.Tensor:
    """f32[..., K] — seconds of ``[t0, t1)`` in each time bucket (K equal
    widths over ``[0, horizon)``, the last one open-ended); zero where
    ``gate`` is False."""
    k = m.bucket_dt.shape[-1]
    dev = m.bucket_dt.device
    w = (m.horizon / float(k))[..., None]
    lo = torch.arange(k, dtype=torch.float32, device=dev) * w
    hi = torch.where(torch.arange(k, device=dev) == k - 1, INF, lo + w)
    t0 = torch.as_tensor(t0, dtype=torch.float32, device=dev)[..., None]
    t1 = torch.as_tensor(t1, dtype=torch.float32, device=dev)[..., None]
    ov = torch.clamp(torch.minimum(t1, hi) - torch.maximum(t0, lo), min=0.0)
    return torch.where(torch.as_tensor(gate, device=dev)[..., None], ov, 0.0)


def accrue_interval(m: MetricsState, *, t0, t1, util, watts, fleet,
                    backlog, flows, busy_hosts, dt) -> MetricsState:
    """Book one committed interval ``[t0, t1)``: every observable is
    constant over it, so ``value * overlap`` is each bucket's exact
    integral.  ``backlog`` and ``flows`` are i32, ``busy_hosts``
    f32[..., H] (1.0 where a host runs a cloudlet)."""
    gate = m.enabled == 1
    ov = bucket_overlap(m, t0, t1, gate)
    col = lambda x: x.to(torch.float32)[..., None]
    return dataclasses.replace(
        m,
        bucket_dt=m.bucket_dt + ov,
        bucket_util=m.bucket_util + ov * col(util),
        bucket_watts=m.bucket_watts + ov * col(watts),
        bucket_fleet=m.bucket_fleet + ov * col(fleet),
        bucket_backlog=m.bucket_backlog + ov * col(backlog),
        bucket_flows=m.bucket_flows + ov * col(flows),
        peak_backlog=torch.where(gate, torch.maximum(m.peak_backlog,
                                                     backlog),
                                 m.peak_backlog).to(torch.int32),
        host_busy_s=m.host_busy_s + torch.where(gate, dt, 0.0)[..., None]
        * busy_hosts)


def hist_index(edges: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """i64[..., N] — bin of each value of ``v`` against ``edges``
    ([..., NB+1] or one shared [NB+1]): ``searchsorted(right=True) - 1``,
    clipped, so a value on an edge goes to the bin above it."""
    nb = edges.shape[-1] - 1
    idx = torch.searchsorted(edges.contiguous(), v.contiguous(), right=True)
    return torch.clamp(idx - 1, 0, nb - 1)


def _hist_add(hist: torch.Tensor, idx: torch.Tensor, one: torch.Tensor
              ) -> torch.Tensor:
    """``hist`` [..., NB] plus ``one`` [..., N] scattered at ``idx``: an
    integer scatter, exact in any order."""
    nb = hist.shape[-1]
    flat = hist.reshape(-1, nb)
    rows = flat.shape[0]
    base = torch.arange(rows, device=hist.device)[:, None] * nb
    return flat.reshape(-1).index_add(
        0, (idx.reshape(rows, -1) + base).reshape(-1),
        one.reshape(-1)).view(hist.shape)


def fill_retirement(m: MetricsState, *, newly, finish, submit, start,
                    bound) -> MetricsState:
    """Book the cloudlets that retired in this commit (``newly``,
    bool[..., C]) into the histograms and the SLA watermarks; ``bound``
    is each cloudlet's response bound (``sla_factor * length /
    req_mips``; a factor of 0 disarms breaches).  Masked-out rows add 0,
    so a quiesced step is a bit-exact identity."""
    gate = (m.enabled == 1)[..., None]
    mask = newly & gate
    one = mask.to(torch.int32)
    resp = finish - submit
    breach = mask & (m.sla_factor[..., None] > 0.0) & (resp > bound)
    first = torch.where(breach, finish, INF)
    first = (first.amin(dim=-1) if first.shape[-1]
             else torch.full(first.shape[:-1], INF, device=first.device))
    return dataclasses.replace(
        m,
        hist_response=_hist_add(m.hist_response, hist_index(m.edges, resp),
                                one),
        hist_exec=_hist_add(m.hist_exec, hist_index(m.edges, finish - start),
                            one),
        hist_wait=_hist_add(m.hist_wait, hist_index(m.edges, start - submit),
                            one),
        sla_breaches=(m.sla_breaches
                      + breach.sum(dim=-1, dtype=torch.int32)),
        first_breach_t=torch.minimum(m.first_breach_t, first))
