"""Host power models + energy integration (``repro.core.energy`` in PyTorch).

Every host owns ``idle_w``/``peak_w`` watts and a normalized
utilization→power curve ``power_curve f32[H, K_CURVE]`` (control points
at utilizations 0, 1/(K-1), ..., 1).  Power is
``idle_w + (peak_w - idle_w) * interp(curve, utilization)``.  Rates are
piecewise-constant between events, so the engine accrues the exact
integral ``watts * dt`` per host per event.

Units: watts, joules, utilization in [0, 1].
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.spans import span

__all__ = ["K_CURVE", "SPEC_G4_WATTS", "SPEC_G5_WATTS", "linear_curve",
           "normalize_watts", "make_power_model", "with_power_model",
           "host_power", "host_utilization", "utilization_of", "step_power",
           "energy_total_j"]

# control points per curve: utilizations 0%, 10%, ..., 100% (SPECpower grid)
K_CURVE = 11

# SPECpower-style ladders (watts at 0..100% utilization in 10% steps)
SPEC_G4_WATTS = (86.0, 89.4, 92.6, 96.0, 99.5, 102.0, 106.0, 108.0,
                 112.0, 114.0, 117.0)          # HP ProLiant ML110 G4
SPEC_G5_WATTS = (93.7, 97.0, 101.0, 105.0, 110.0, 116.0, 121.0, 125.0,
                 129.0, 133.0, 135.0)          # HP ProLiant ML110 G5


def _linear_curve_np() -> np.ndarray:
    # i * f32(1/(K-1)) in f32: the same bits as the JAX package's curve
    return (np.arange(K_CURVE, dtype=np.float32)
            * np.float32(1.0 / (K_CURVE - 1)))


def linear_curve(*, device=None) -> torch.Tensor:
    """f32[K] — the identity curve: power scales linearly idle→peak."""
    return torch.from_numpy(_linear_curve_np()).to(resolve_device(device))


def normalize_watts(watts, *, device=None
                    ) -> tuple[float, float, torch.Tensor]:
    """(idle_w, peak_w, f32[K] normalized curve) from a watts ladder."""
    w = np.asarray(watts, np.float64)
    if w.shape != (K_CURVE,):
        raise ValueError(f"watts ladder must have {K_CURVE} points, "
                         f"got shape {w.shape}")
    span = w[-1] - w[0]
    if span <= 0:
        raise ValueError("peak watts must exceed idle watts")
    curve = torch.from_numpy(((w - w[0]) / span).astype(np.float32))
    return float(w[0]), float(w[-1]), curve.to(resolve_device(device))


def _as_f32(x, shape, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).broadcast_to(
            shape).contiguous()
    a = np.broadcast_to(np.asarray(x, np.float32), shape)
    with span("sync.build.copy"):
        return torch.from_numpy(np.array(a)).to(device)


def make_power_model(n_hosts: int, idle_w, peak_w, curve=None, *,
                     device=None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(idle_w f32[H], peak_w f32[H], power_curve f32[H, K]) field triple.

    ``curve`` is a normalized f32[K] (default ``linear_curve()``) or a
    per-host f32[H, K] block.
    """
    dev = resolve_device(device)
    idle = _as_f32(idle_w, (n_hosts,), dev)
    peak = _as_f32(peak_w, (n_hosts,), dev)
    c = _linear_curve_np() if curve is None else curve
    if isinstance(c, torch.Tensor):
        c = c.to(device=dev, dtype=torch.float32)
    else:
        with span("sync.build.copy"):
            c = torch.from_numpy(np.asarray(c, np.float32)).to(dev)
    if c.ndim == 1:
        c = c[None].expand(n_hosts, K_CURVE)
    if tuple(c.shape) != (n_hosts, K_CURVE):
        raise ValueError(f"curve must be [K]={K_CURVE} or "
                         f"[H={n_hosts}, {K_CURVE}]; got {tuple(c.shape)}")
    return idle, peak, c.contiguous()


def with_power_model(hosts, idle_w, peak_w, curve=None):
    """A copy of a ``HostState`` with the power-model fields attached."""
    n = hosts.num_pes.shape[0]
    idle, peak, c = make_power_model(n, idle_w, peak_w, curve,
                                     device=hosts.num_pes.device)
    return dataclasses.replace(hosts, idle_w=idle, peak_w=peak,
                               power_curve=c)


def host_power(hosts, util: torch.Tensor) -> torch.Tensor:
    """f32[..., H] watts at per-host utilization ``util`` (clamped to
    [0, 1]; any leading lane axes); invalid hosts draw exactly 0 W."""
    u = torch.clamp(util, 0.0, 1.0) * (K_CURVE - 1)
    lo = torch.clamp(u.to(torch.int32), 0, K_CURVE - 2)
    frac = u - lo.to(torch.float32)
    lo = lo.long()[..., None]
    c_lo = torch.gather(hosts.power_curve, -1, lo)[..., 0]
    c_hi = torch.gather(hosts.power_curve, -1, lo + 1)[..., 0]
    c = c_lo + (c_hi - c_lo) * frac
    watts = hosts.idle_w + (hosts.peak_w - hosts.idle_w) * c
    return torch.where(hosts.valid, watts, 0.0)


def utilization_of(hosts, consumed: torch.Tensor) -> torch.Tensor:
    """f32[..., H] utilization from each host's consumed MIPS (f64, as
    ``scheduling.host_consumed`` sums them), rounded to f32 once."""
    cap = hosts.capacity_mips
    return torch.where(cap > 0.0, consumed.view(cap.shape).to(torch.float32)
                       / torch.clamp(cap, min=1e-30), 0.0)


def host_utilization(dc, rates: torch.Tensor) -> torch.Tensor:
    """f32[H] consumed MIPS / capacity MIPS per host, given cloudlet rates.

    The per-host sum runs in f64 (``scheduling.host_consumed``): over
    each VM's cloudlets, then over each host's VMs in a fixed order.  Its
    order differs from XLA's, so compare it with the JAX package by
    tolerance.
    """
    # imported here: scheduling imports state, which imports this module
    from repro_torch.core import scheduling
    batch = scheduling.lane_axis(dc)
    lanes = scheduling.lanes_of(batch)
    plan = scheduling.host_plan(batch, lanes)
    return utilization_of(dc.hosts,
                          scheduling.host_consumed(rates, lanes, plan))


def step_power(dc, rates: torch.Tensor) -> torch.Tensor:
    """f32[H] watts drawn by each host while ``rates`` hold (one event)."""
    return host_power(dc.hosts, host_utilization(dc, rates))


def energy_total_j(dc) -> torch.Tensor:
    """f32[] total joules accrued across real hosts (``num_pes > 0``)."""
    return torch.sum(torch.where(dc.hosts.num_pes > 0, dc.hosts.energy_j,
                                 0.0), dim=-1)
