"""Grouped-segment primitives (``repro.core.segments`` in PyTorch).

Entities stored as contiguous runs of a segment id (cloudlets grouped by
VM, VMs sorted by host) need per-run ranks, cumsums and minima.  As in
the JAX package, everything relies on the grouped layout, not on unique
ids: two runs with the same id are distinct segments.
"""
from __future__ import annotations

import torch

__all__ = ["run_starts", "run_ids", "segment_rank", "segment_cumsum",
           "segment_min", "run_scan", "rounds_for", "pairwise_sum"]


def _is_start(seg_ids: torch.Tensor) -> torch.Tensor:
    """bool[N] — True at the first slot of each contiguous run."""
    head = torch.ones((min(seg_ids.shape[0], 1),), dtype=torch.bool,
                      device=seg_ids.device)
    return torch.cat([head, seg_ids[1:] != seg_ids[:-1]])


def run_starts(seg_ids: torch.Tensor) -> torch.Tensor:
    """i32[N] index of the first slot of each slot's run (a running max)."""
    n = seg_ids.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=seg_ids.device)
    marked = torch.where(_is_start(seg_ids), idx, -1)
    if n == 0:
        return marked
    return torch.cummax(marked, dim=0).values


def run_ids(seg_ids: torch.Tensor) -> torch.Tensor:
    """i32[N] dense 0-based run index per slot (monotone over slots)."""
    return torch.cumsum(_is_start(seg_ids).to(torch.int32), dim=0,
                        dtype=torch.int32) - 1


def segment_rank(seg_ids: torch.Tensor) -> torch.Tensor:
    """i32[N] position of each slot within its run (resets per run)."""
    n = seg_ids.shape[0]
    return (torch.arange(n, dtype=torch.int32, device=seg_ids.device)
            - run_starts(seg_ids))


def segment_cumsum(values: torch.Tensor, seg_ids: torch.Tensor, *,
                   exclusive: bool = True) -> torch.Tensor:
    """Cumulative sum restarting at each contiguous run of ``seg_ids``:
    a global prefix sum re-based at each run start."""
    start = run_starts(seg_ids).long()
    csum = torch.cumsum(values, dim=0, dtype=values.dtype)
    excl = csum - values
    out = excl - excl[start]
    if not exclusive:
        out = out + values
    return out


def segment_min(values: torch.Tensor, seg_ids: torch.Tensor) -> torch.Tensor:
    """Minimum within each contiguous run, broadcast back per slot."""
    rid = run_ids(seg_ids).long()
    mins = torch.zeros_like(values).scatter_reduce(
        0, rid, values, reduce="amin", include_self=False)
    return mins[rid]


def rounds_for(longest: int) -> int:
    """Doubling rounds ``run_scan`` needs for runs of up to ``longest``."""
    return max(0, (int(longest) - 1).bit_length())


def run_scan(values: torch.Tensor, rel: torch.Tensor, rounds: int
             ) -> torch.Tensor:
    """Inclusive sum along each contiguous run, in a fixed order.

    ``rel`` is each slot's offset from its run's first slot.  Round k
    adds the partial sum 2^k slots back when it lies in the same run
    (Hillis-Steele doubling).  The additions that reach a slot depend
    only on its run's values and on its offset, not on where the run
    lies or what lies beside it, so a run gives the same bits in any
    layout: alone, or as one lane of a batch.  ``rounds`` is
    ``rounds_for`` of the longest run; more rounds change nothing.
    """
    n = values.shape[0]
    for k in range(rounds):
        s = 1 << k
        if s >= n:
            break
        values = torch.cat([values[:s], torch.where(
            rel[s:] >= s, values[s:] + values[:-s], values[s:])])
    return values


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by a pairwise tree, the axis padded with
    zeros to a power of two.  Zeros appended to the axis leave every
    partial sum as it was, so a row gives the same bits at any padded
    length and beside any other rows (``torch.sum`` of more than two
    values picks its order by the tensor's shape; of two, every order
    gives a + b)."""
    n = x.shape[-1]
    width = 1 << max(0, (n - 1).bit_length())
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        x = x.view(x.shape[:-1] + (-1, 2)).sum(dim=-1)
    return x[..., 0]
