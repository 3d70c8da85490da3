"""Grouped-segment primitives (``repro.core.segments`` in PyTorch).

Entities stored as contiguous runs of a segment id (cloudlets grouped by
VM, VMs sorted by host) need per-run ranks, cumsums and minima.  As in
the JAX package, everything relies on the grouped layout, not on unique
ids: two runs with the same id are distinct segments.
"""
from __future__ import annotations

import torch

__all__ = ["run_starts", "run_ids", "segment_rank", "segment_cumsum",
           "segment_min"]


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
