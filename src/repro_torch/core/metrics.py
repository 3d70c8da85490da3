"""The in-run metrics plane's state (``repro.core.metrics`` in PyTorch).

Only the inert plane is ported so far: ``DatacenterState`` carries a
``MetricsState`` in every scenario, and the static engine never touches
it.  The probes themselves come with the metrics slice of the port.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

__all__ = ["MetricsState", "no_metrics"]

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


def no_metrics(n_hosts: int, *, device=None) -> MetricsState:
    """Inert plane (enabled=0, K=1, NB=2) — the default on every state."""
    dev = resolve_device(device)
    f32 = lambda shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    i32 = lambda shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    return MetricsState(
        enabled=i32(()),
        horizon=f32(()),
        sla_factor=f32(()),
        edges=torch.tensor([0.0, 1.0, INF], dtype=torch.float32, device=dev),
        bucket_dt=f32((1,)), bucket_util=f32((1,)), bucket_watts=f32((1,)),
        bucket_fleet=f32((1,)), bucket_backlog=f32((1,)),
        bucket_flows=f32((1,)),
        hist_response=i32((2,)), hist_exec=i32((2,)), hist_wait=i32((2,)),
        sla_breaches=i32(()),
        first_breach_t=torch.full((), INF, dtype=torch.float32, device=dev),
        peak_backlog=i32(()),
        host_busy_s=f32((n_hosts,)))
