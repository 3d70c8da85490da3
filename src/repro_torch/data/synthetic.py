"""Arrival-time sampling at scenario build time (the NumPy helpers of
``repro.data.synthetic``).

Pure NumPy on a caller's ``np.random.Generator``: the same generator
state gives the same times as the JAX package's copies.  The sampled
times feed ``state.make_stream``, which sorts them on the host.
"""
from __future__ import annotations

import numpy as np

__all__ = ["thinned_arrivals", "mmpp_segments"]


def thinned_arrivals(rng, rate_fn, horizon: float, rate_max: float
                     ) -> np.ndarray:
    """Arrival times of an inhomogeneous Poisson process on [0, horizon).

    Ogata thinning: draw a homogeneous process at the envelope rate
    ``rate_max`` and keep each point ``t`` with probability
    ``rate_fn(t) / rate_max``.  ``rate_fn`` must be vectorized and
    bounded by ``rate_max`` on the horizon.
    """
    if rate_max <= 0.0 or horizon <= 0.0:
        return np.zeros((0,), np.float64)
    # over-draw the envelope count by 6 sigma so one pass suffices
    mean = rate_max * horizon
    n_env = int(mean + 6.0 * np.sqrt(mean) + 16.0)
    gaps = rng.exponential(1.0 / rate_max, n_env)
    t = np.cumsum(gaps)
    t = t[t < horizon]
    keep = rng.uniform(0.0, 1.0, t.shape[0]) * rate_max < rate_fn(t)
    return t[keep]


def mmpp_segments(rng, horizon: float, *, rate_low: float, rate_high: float,
                  mean_dwell_low: float, mean_dwell_high: float,
                  start_high: bool = False):
    """(start, end, rate) dwell segments of a 2-state MMPP on [0, horizon).

    The modulating chain alternates LOW/HIGH with exponential dwell
    times; within a segment arrivals are Poisson at the segment's rate
    (sampled by the caller, as ``core.workloads.mmpp_stream`` does).
    """
    segs, t, high = [], 0.0, start_high
    while t < horizon:
        dwell = rng.exponential(
            mean_dwell_high if high else mean_dwell_low)
        end = min(t + max(dwell, 1e-9), horizon)
        segs.append((t, end, rate_high if high else rate_low))
        t, high = end, not high
    return segs
