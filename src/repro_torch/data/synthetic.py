"""Synthetic data: the LM token batches of training, and arrival-time
sampling at scenario build time (``repro.data.synthetic``).

LM batches: tokens are a pure function of (seed, step), so a restart is
exactly reproducible from the step counter alone.  Targets are next-token
shifted, with a learnable structure mixed in: on about 75% of positions
the token at t is (offset + t) mod 7, the offset drawn per sequence, so a
few training steps show a falling loss.  The draws come from a
``torch.Generator`` on the CPU seeded by (seed, step), not from
``jax.random``: the structure is JAX's, the numbers are not (tests that
compare with JAX feed JAX's batches in).  The batch is then moved to the
caller's device, so the card and the CPU see the same tokens.  Across
ranks every rank makes the global batch and ``shard_batch`` keeps its
rows, so a run's batches are the same at any world size.

Arrival times: pure NumPy on a caller's ``np.random.Generator``: the same
generator state gives the same times as the JAX package's copies.  The
sampled times feed ``state.make_stream``, which sorts them on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.rules import P, batch_pspec, shard_leaf

__all__ = ["SyntheticConfig", "make_batch", "batch_iterator", "config_for",
           "shard_batch", "thinned_arrivals", "mmpp_segments"]


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    batch: int
    seq_len: int
    vocab_size: int
    num_codebooks: int = 0
    vision_tokens: int = 0
    d_model: int = 0
    pattern_period: int = 7     # learnable bigram structure strength
    structured_frac: float = 0.75


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator whose state is a function of (seed, step) alone."""
    state = np.random.SeedSequence([seed, step]).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator().manual_seed(int(state) & (2 ** 63 - 1))


def _tokens_for(gen: torch.Generator, scfg: SyntheticConfig, shape):
    noise = torch.randint(0, scfg.vocab_size, shape, generator=gen)
    # periodic structure: token at t is (offset + t) % period on a fraction
    # of positions -> a model can learn it, loss visibly decreases
    pos = torch.arange(shape[1])
    offset = torch.randint(0, scfg.pattern_period,
                           (shape[0],) + (1,) * (len(shape) - 1),
                           generator=gen)
    base = (offset + pos.reshape(1, -1, *([1] * (len(shape) - 2)))) \
        % scfg.pattern_period
    structured = base % scfg.vocab_size
    mask = torch.rand(shape, generator=gen) < scfg.structured_frac
    return torch.where(mask, structured, noise).to(torch.int32)


def make_batch(scfg: SyntheticConfig, step: int, *, seed: int = 0,
               device=None) -> dict:
    """{"tokens", "targets"} i32 [B,S] (or [B,S,CB]), and "vision_embeds"
    f32 [B,P,D] when the config has a vision prefix, on ``device`` (the
    card unless "cpu")."""
    dev = resolve_device(device)
    gen = _generator(seed, step)
    shape = (scfg.batch, scfg.seq_len + 1)
    if scfg.num_codebooks:
        shape = shape + (scfg.num_codebooks,)
    toks = _tokens_for(gen, scfg, shape)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if scfg.vision_tokens:
        batch["vision_embeds"] = torch.randn(
            (scfg.batch, scfg.vision_tokens, scfg.d_model), generator=gen,
            dtype=torch.float32)
    return {k: v.contiguous().to(dev) for k, v in batch.items()}


def shard_batch(batch: dict, mesh, rules, microbatches: int = 1) -> dict:
    """This rank's rows of a global batch.  JAX's step cuts the global
    batch into ``microbatches`` runs of B/n rows; each run's rows are
    split over the batch axes by ``batch_pspec`` (at B/n rows), and the
    rank's rows of every run are kept, runs in order, so the step's own
    cut of the result gives the rank's rows of each microbatch."""
    out = {}
    for key, x in batch.items():
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} not divisible by microbatches "
                             f"{microbatches}")
        spec = batch_pspec(mesh, rules, x.ndim, b // microbatches)
        runs = x.reshape(microbatches, b // microbatches, *x.shape[1:])
        mine = shard_leaf(runs, P(None, *spec), mesh)
        out[key] = mine.reshape(-1, *x.shape[1:])
    return out


def batch_iterator(scfg: SyntheticConfig, *, start_step: int = 0,
                   seed: int = 0, device=None):
    step = start_step
    while True:
        yield step, make_batch(scfg, step, seed=seed, device=device)
        step += 1


def config_for(cfg, batch: int, seq_len: int) -> SyntheticConfig:
    """The batches of model config ``cfg`` (a ``models.config.ModelConfig``)
    at ``batch`` x ``seq_len``."""
    return SyntheticConfig(batch=batch, seq_len=seq_len,
                           vocab_size=cfg.vocab_size,
                           num_codebooks=cfg.num_codebooks,
                           vision_tokens=cfg.vision_tokens,
                           d_model=cfg.d_model)


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
