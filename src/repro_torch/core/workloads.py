"""Arrival processes (``repro.core.workloads``' generators in the port).

``poisson_arrivals`` and ``bursty_arrivals`` build a resident cloudlet
block from random draws; each is a thin draw from an explicit
``torch.Generator`` over a plain function of the draws
(``poisson_from_draws``: exponential gaps; ``bursty_from_noise``: the
uniform jitter).  Their random stream is the port's own: one seed gives
the same cloudlets in the port every time, but not the bits of the JAX
package's ``jax.random`` draws (fed the same draws, the plain functions
give JAX's cloudlets).

``diurnal_stream`` and ``mmpp_stream`` draw every arrival on the host
from ``np.random.default_rng(seed)`` and build a sorted chunk table with
``state.make_stream``, so one seed gives the JAX package's stream
exactly.

The LM-fleet profiles (``LmWorkloadProfile``, ``profile_from_roofline``,
``cloudlets_from_profile``, ``make_tpu_hosts``) render one (arch x
shape) cell of an LM workload as cloudlet parameters and a pool of
accelerator hosts, with the JAX package's NumPy arithmetic: 1 MI is 1e6
FLOP, one simulated TPU-v5e chip is ``TPU_V5E_MIPS`` (a parameter of the
simulated fleet, not a measurement).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import state as S
from repro_torch.data.synthetic import mmpp_segments, thinned_arrivals
from repro_torch.device import resolve_device

__all__ = ["poisson_arrivals", "poisson_from_draws", "bursty_arrivals",
           "bursty_from_noise", "diurnal_rate", "diurnal_stream",
           "mmpp_stream", "LmWorkloadProfile", "profile_from_roofline",
           "cloudlets_from_profile", "TPU_V5E_MIPS", "make_tpu_hosts"]

TPU_V5E_MIPS = 197e6     # one simulated chip's MIPS (1 MI = 1e6 FLOP)
_MI_PER_FLOP = 1e-6


def _f32(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, np.float32))
    return x.to(device=device, dtype=torch.float32)


def poisson_from_draws(draws, *, rate_per_vm: float, horizon: float,
                       length_mi: float, file_size: float = 0.0,
                       output_size: float = 0.0, device=None
                       ) -> S.CloudletState:
    """The Poisson block from f32[n_vms, max_per_vm] unit-rate
    exponential draws: gaps ``draws / rate_per_vm``, submit times their
    running sum along each VM's row (f32), slots past ``horizon`` parked
    as ``CL_EMPTY`` with nothing remaining."""
    dev = resolve_device(device)
    draws = _f32(draws, dev)
    n_vms, per_vm = draws.shape
    submit = torch.cumsum(draws / rate_per_vm, dim=1).reshape(-1)
    vm_ids = np.repeat(np.arange(n_vms, dtype=np.int32), per_vm)
    cl = S.make_cloudlets(vm_ids, length_mi, submit, file_size, output_size,
                          device=dev)
    alive = submit <= horizon
    return dataclasses.replace(
        cl, state=torch.where(alive, cl.state, S.CL_EMPTY).to(torch.int32),
        remaining=torch.where(alive, cl.remaining, 0.0))


def poisson_arrivals(gen: torch.Generator, n_vms: int, *,
                     rate_per_vm: float, horizon: float, max_per_vm: int,
                     length_mi: float, file_size: float = 0.0,
                     output_size: float = 0.0, device=None
                     ) -> S.CloudletState:
    """A Poisson process a VM: ``max_per_vm`` slots a VM with exponential
    gaps drawn from ``gen`` (on its device), arrivals past ``horizon``
    parked empty so shapes stay fixed."""
    draws = torch.empty((n_vms, max_per_vm), dtype=torch.float32,
                        device=gen.device).exponential_(1.0, generator=gen)
    return poisson_from_draws(draws, rate_per_vm=rate_per_vm,
                              horizon=horizon, length_mi=length_mi,
                              file_size=file_size, output_size=output_size,
                              device=device)


def bursty_from_noise(noise, *, burst_every: float, burst_size: int,
                      n_bursts: int, length_mi: float, device=None
                      ) -> S.CloudletState:
    """The bursty block from f32[n_vms, burst_size * n_bursts] jitter:
    burst k's slots submit at ``k * burst_every`` plus their jitter."""
    dev = resolve_device(device)
    noise = _f32(noise, dev)
    n_vms, per_vm = noise.shape
    base = (torch.arange(n_bursts, dtype=torch.float32, device=dev)
            * burst_every).repeat_interleave(burst_size)
    submit = (base[None, :] + noise).reshape(-1)
    vm_ids = np.repeat(np.arange(n_vms, dtype=np.int32), per_vm)
    return S.make_cloudlets(vm_ids, length_mi, submit, device=dev)


def bursty_arrivals(gen: torch.Generator, n_vms: int, *,
                    burst_every: float, burst_size: int, n_bursts: int,
                    jitter: float, length_mi: float, device=None
                    ) -> S.CloudletState:
    """On/off bursts (flash-crowd studies): every ``burst_every`` s each
    VM gets ``burst_size`` cloudlets, each with a jitter drawn from
    ``gen`` uniformly in ``[0, jitter)``."""
    u = torch.rand((n_vms, burst_size * n_bursts), generator=gen,
                   dtype=torch.float32, device=gen.device)
    return bursty_from_noise(u * jitter, burst_every=burst_every,
                             burst_size=burst_size, n_bursts=n_bursts,
                             length_mi=length_mi, device=device)


def diurnal_rate(t, *, base: float, peak: float, period: float,
                 phase: float = 0.0):
    """Sinusoidal day/night request rate: ``base`` at the trough,
    ``peak`` mid-period."""
    t = np.asarray(t, np.float64)
    return base + (peak - base) * 0.5 * (
        1.0 - np.cos(2.0 * np.pi * (t - phase) / period))


def _stream(rng, times, n_vms, length_mi, file_size, output_size, chunk,
            device) -> S.ArrivalStream:
    n = times.shape[0]
    vm = rng.integers(0, n_vms, n).astype(np.int32)
    lo, hi = length_mi
    lens = rng.uniform(lo, hi, n).astype(np.float32)
    return S.make_stream(vm, lens, times.astype(np.float32),
                         file_size=file_size, output_size=output_size,
                         chunk=chunk, device=device)


def diurnal_stream(seed: int, n_vms: int, *, base_rate: float,
                   peak_rate: float, period: float, horizon: float,
                   length_mi=(100.0, 2000.0), file_size: float = 0.0,
                   output_size: float = 0.0, chunk: int = 256,
                   device=None) -> S.ArrivalStream:
    """Chunked arrival stream with a diurnal (sinusoidal) aggregate rate:
    times by thinning against the ``peak_rate`` envelope, VM targets
    uniform, lengths uniform over ``length_mi``."""
    rng = np.random.default_rng(seed)
    rate = lambda t: diurnal_rate(t, base=base_rate, peak=peak_rate,
                                  period=period)
    times = thinned_arrivals(rng, rate, horizon, peak_rate)
    return _stream(rng, times, n_vms, length_mi, file_size, output_size,
                   chunk, device)


def mmpp_stream(seed: int, n_vms: int, *, rate_low: float, rate_high: float,
                mean_dwell_low: float, mean_dwell_high: float,
                horizon: float, length_mi=(100.0, 2000.0),
                file_size: float = 0.0, output_size: float = 0.0,
                chunk: int = 256, device=None) -> S.ArrivalStream:
    """Bursty 2-state Markov-modulated Poisson stream: LOW/HIGH dwell
    segments from ``data.synthetic.mmpp_segments``, homogeneous Poisson
    arrivals within each.  The HIGH bursts overflow a small window and
    exercise the backlog."""
    rng = np.random.default_rng(seed)
    segs = mmpp_segments(rng, horizon, rate_low=rate_low,
                         rate_high=rate_high,
                         mean_dwell_low=mean_dwell_low,
                         mean_dwell_high=mean_dwell_high)
    times = []
    for t0, t1, rate in segs:
        n_seg = rng.poisson(rate * (t1 - t0))
        times.append(rng.uniform(t0, t1, n_seg))
    times = np.sort(np.concatenate(times)) if times else np.zeros((0,))
    return _stream(rng, times, n_vms, length_mi, file_size, output_size,
                   chunk, device)


# ---------------------------------------------------------------------------
# LM-fleet profiles (an LM workload's roofline rendered as cloudlets)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LmWorkloadProfile:
    """One (arch x shape) cell rendered as cloudlet parameters."""
    name: str
    length_mi: float        # FLOPs per step/request, in MI (1e6 FLOP)
    file_size_mb: float     # input bytes per request (tokens, embeddings)
    output_size_mb: float   # output bytes per request
    hbm_gb_per_chip: float  # peak device memory: sets the VM's RAM demand
    chips: int              # devices the cell was sized for


def profile_from_roofline(name: str, *, hlo_gflops: float,
                          in_bytes: float = 0.0, out_bytes: float = 0.0,
                          hbm_bytes_per_chip: float = 0.0, chips: int = 256
                          ) -> LmWorkloadProfile:
    """A cell's FLOPs and bytes in simulator units."""
    return LmWorkloadProfile(
        name=name,
        length_mi=hlo_gflops * 1e9 * _MI_PER_FLOP,
        file_size_mb=in_bytes / 1e6,
        output_size_mb=out_bytes / 1e6,
        hbm_gb_per_chip=hbm_bytes_per_chip / 1e9,
        chips=chips,
    )


def cloudlets_from_profile(profile: LmWorkloadProfile, n_vms: int,
                           *, requests_per_vm: int, period: float,
                           first_at: float = 0.0, device=None
                           ) -> S.CloudletState:
    """A steady request stream of this LM workload against a VM fleet:
    ``requests_per_vm`` requests a VM, ``period`` apart (f32 times)."""
    vm_ids = np.repeat(np.arange(n_vms, dtype=np.int32), requests_per_vm)
    waves = np.tile(np.arange(requests_per_vm, dtype=np.float32), n_vms)
    submit = first_at + waves * period
    return S.make_cloudlets(vm_ids, profile.length_mi, submit,
                            profile.file_size_mb, profile.output_size_mb,
                            device=device)


def make_tpu_hosts(n_chips: int, *, hbm_gb: float = 16.0,
                   ici_gbps: float = 50.0, device=None) -> S.HostState:
    """A pool of TPU-v5e-class hosts in simulator units (1 chip = 1 PE,
    "RAM" = HBM in MB, bandwidth in MB/s)."""
    return S.make_hosts(
        np.full(n_chips, 1), np.full(n_chips, TPU_V5E_MIPS),
        np.full(n_chips, hbm_gb * 1024.0),
        np.full(n_chips, ici_gbps * 1000.0),
        np.full(n_chips, 1e9), device=device)
