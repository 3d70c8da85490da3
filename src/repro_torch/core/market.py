"""Cloud market modeling, §3.3 (``repro.core.market`` in PyTorch).

Memory and storage bill at VM creation (provisioning), CPU per PE-second
consumed and bandwidth per MB transferred (engine).  This module holds
the quotes, the per-VM bill, the surge pricing of revenue sweeps, and
the spot market: the piecewise-constant price tracks of the autoscaler
(``AutoscalerState.spot_t``/``spot_price``) and of federated providers
(``SpotMarket``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import state as S
from repro_torch.device import resolve_device

__all__ = ["quote_vm", "quote_cloudlet", "bill_by_vm", "flat_rates",
           "PricingPolicy", "tiered_cpu_rates", "SpotMarket",
           "make_spot_market", "spot_price_at", "next_spot_boundary",
           "mean_spot_price", "cheapest_spot_provider"]


def quote_vm(rates: S.MarketRates, *, ram: float, size: float
             ) -> torch.Tensor:
    """Up-front cost of creating one VM (memory + storage)."""
    return rates.cost_per_mem * ram + rates.cost_per_storage * size


def quote_cloudlet(rates: S.MarketRates, *, length_mi: float,
                   host_mips_pe: float, file_size: float = 0.0,
                   output_size: float = 0.0) -> torch.Tensor:
    """Expected cost of one task unit on a given host class: CPU per
    PE-second (L/M seconds whatever the sharing) plus its transfers."""
    mips = torch.as_tensor(host_mips_pe, dtype=torch.float32,
                           device=rates.cost_per_cpu_sec.device)
    pe_seconds = length_mi / torch.clamp(mips, min=1e-30)
    return (rates.cost_per_cpu_sec * pe_seconds
            + rates.cost_per_bw * (file_size + output_size))


def bill_by_vm(dc: S.DatacenterState) -> torch.Tensor:
    """f32[V] — bill attribution per VM from a final state: executed MI
    over host MIPS at the CPU rate, finished transfer volumes at the BW
    rate, and creation charges of every VM that was placed."""
    cl, vms = dc.cloudlets, dc.vms
    nv = vms.req_pes.shape[0]
    nh = dc.hosts.num_pes.shape[0]
    seg = torch.clamp(cl.vm, 0, nv - 1).long()
    seg_sum = lambda x: torch.zeros((nv,), dtype=torch.float32,
                                    device=x.device).index_add_(0, seg, x)

    executed = cl.length - cl.remaining
    host_of_cl = vms.host[seg]
    mips = dc.hosts.mips_per_pe[torch.clamp(host_of_cl, 0, nh - 1).long()]
    pe_sec = torch.where(host_of_cl >= 0,
                         executed / torch.clamp(mips, min=1e-30), 0.0)
    cpu = seg_sum(pe_sec) * dc.rates.cost_per_cpu_sec

    done = cl.state == S.CL_DONE
    moved = torch.where(done, cl.file_size + cl.output_size, 0.0)
    bw = seg_sum(moved) * dc.rates.cost_per_bw

    placed = (vms.state == S.VM_ACTIVE) | (vms.state == S.VM_DESTROYED)
    create = torch.where(placed,
                         dc.rates.cost_per_mem * vms.ram
                         + dc.rates.cost_per_storage * vms.size, 0.0)
    return cpu + bw + create


def flat_rates(cpu=0.01, mem=0.001, storage=0.0001, bw=0.002, *,
               device=None) -> S.MarketRates:
    return S.make_market(cpu, mem, storage, bw, device=device)


class PricingPolicy(NamedTuple):
    """Provider-side pricing knobs for revenue sweeps (beyond the paper)."""
    base: S.MarketRates
    surge_threshold: torch.Tensor   # utilization above which CPU surges
    surge_factor: torch.Tensor


def tiered_cpu_rates(policy: PricingPolicy, utilization) -> S.MarketRates:
    """Surge pricing: the CPU rate scales when the datacenter runs hot."""
    base = policy.base.cost_per_cpu_sec
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                     device=base.device)
    surge = torch.where(as_t(utilization) > as_t(policy.surge_threshold),
                        as_t(policy.surge_factor), 1.0)
    return dataclasses.replace(policy.base, cost_per_cpu_sec=base * surge)


# ---------------------------------------------------------------------------
# Spot market
# ---------------------------------------------------------------------------
class SpotMarket(NamedTuple):
    """Piecewise-constant spot prices across D federated providers.

    Segment ``i`` of provider ``d`` charges ``prices[d, i]`` $ per
    alive-VM-second over ``[times[d, i], times[d, i+1])``; the last
    segment extends forever.  Rows start at 0 and strictly increase
    (``make_spot_market`` pads ragged tracks by extending the final
    segment)."""
    times: torch.Tensor     # f32[D, T] segment start times, row[0] = 0
    prices: torch.Tensor    # f32[D, T] $ per alive-VM-second


def make_spot_market(tracks, *, device=None) -> SpotMarket:
    """``SpotMarket`` from per-provider ``(times, prices)`` pairs (ragged
    lengths allowed; shorter tracks are padded past their end)."""
    if not tracks:
        raise ValueError("need at least one provider track")
    ts, ps = [], []
    for times, prices in tracks:
        t = np.asarray(times, np.float32).reshape(-1)
        p = np.asarray(prices, np.float32).reshape(-1)
        if t.shape != p.shape:
            raise ValueError("times and prices must have equal length")
        if t.shape[0] == 0 or t[0] != 0.0 or np.any(np.diff(t) <= 0.0):
            raise ValueError("times must start at 0 and strictly increase")
        ts.append(t)
        ps.append(p)
    width = max(t.shape[0] for t in ts)
    pad_t = [np.concatenate([t, t[-1] + np.arange(1, width - t.shape[0] + 1,
                                                  dtype=np.float32)])
             for t in ts]
    pad_p = [np.concatenate([p, np.full(width - p.shape[0], p[-1],
                                        np.float32)]) for p in ps]
    dev = resolve_device(device)
    return SpotMarket(times=torch.from_numpy(np.stack(pad_t)).to(dev),
                      prices=torch.from_numpy(np.stack(pad_p)).to(dev))


def _clock(scaler: S.AutoscalerState, time) -> torch.Tensor:
    return torch.as_tensor(time, dtype=torch.float32,
                           device=scaler.spot_t.device)


def spot_price_at(scaler: S.AutoscalerState, time) -> torch.Tensor:
    """f32[...] — the current spot price of each lane's track (0 while
    disabled): the last segment whose start is <= ``time``.  The scaler's
    leaves may carry leading lane axes ([..., T]); ``time`` has their
    shape.  The comparison is on exact table values, so the price is
    the JAX engine's bit for bit."""
    t = _clock(scaler, time)
    n = scaler.spot_t.shape[-1]
    idx = (scaler.spot_t <= t[..., None]).sum(dim=-1) - 1
    price = scaler.spot_price.gather(
        -1, torch.clamp(idx, 0, n - 1)[..., None])[..., 0]
    return torch.where(scaler.spot_enabled == 1, price, 0.0)


def next_spot_boundary(scaler: S.AutoscalerState, time) -> torch.Tensor:
    """f32[...] — each lane's earliest segment boundary strictly after
    ``time`` (INF if none, or while the track is disabled).  Boundaries
    are absolute arrivals of the event queue, so the accrual is exact
    between events."""
    t = _clock(scaler, time)
    ahead = torch.where(scaler.spot_t > t[..., None], scaler.spot_t, S.INF)
    nb = (ahead.amin(dim=-1) if ahead.shape[-1]
          else torch.full(t.shape, S.INF, device=t.device))
    return torch.where(scaler.spot_enabled == 1, nb, S.INF)


def mean_spot_price(spot: SpotMarket, *, horizon: float) -> torch.Tensor:
    """f32[D] — each provider's time-averaged price over ``[0, horizon]``
    (the exact integral of the track over the horizon)."""
    hor = torch.tensor(horizon, dtype=torch.float32,
                       device=spot.times.device)
    t = torch.minimum(spot.times, hor)
    nxt = torch.cat([t[:, 1:], hor.expand(t.shape[0], 1)], dim=1)
    seg = torch.clamp(nxt - t, min=0.0)
    return (spot.prices * seg).sum(dim=1) / torch.clamp(hor, min=1e-30)


def cheapest_spot_provider(spot: SpotMarket, *, horizon: float,
                           latency_row=None, latency_weight: float = 0.0
                           ) -> torch.Tensor:
    """i32[] — the provider with the lowest forecast spot price, with an
    optional WAN-distance penalty (``latency_weight`` $ per second of
    ``latency_row``)."""
    score = mean_spot_price(spot, horizon=horizon)
    if latency_row is not None:
        score = score + torch.tensor(latency_weight, dtype=torch.float32,
                                     device=score.device) * torch.as_tensor(
            latency_row, dtype=torch.float32, device=score.device)
    return torch.argmin(score).to(torch.int32)
