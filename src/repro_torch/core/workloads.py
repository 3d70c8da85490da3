"""Streamed arrival processes (``repro.core.workloads``' NumPy-seeded
generators in the port).

``diurnal_stream`` and ``mmpp_stream`` draw every arrival on the host
from ``np.random.default_rng(seed)`` and build a sorted chunk table with
``state.make_stream``, so one seed gives the JAX package's stream
exactly.  The ``jax.random`` generators (``poisson_arrivals``,
``bursty_arrivals``) and the LM-fleet profiles belong to later slices of
the port.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import state as S
from repro_torch.data.synthetic import mmpp_segments, thinned_arrivals

__all__ = ["diurnal_rate", "diurnal_stream", "mmpp_stream"]


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
