"""Fault-tolerant checkpointing: atomic, chunked, async.

Port of ``repro.checkpoint.manager``.  Layout:

    <dir>/step_<N>/
        manifest.json      leaf paths, dtypes, shapes, extra metadata
        shard_<k>.npz      the leaves, chunked ~512 MB per file

Atomicity: everything is written into ``step_<N>.tmp`` and renamed once
the manifest is fsynced, so a crash mid-save never leaves a partial
checkpoint that ``latest_step`` would find.  ``save(..., blocking=False)``
snapshots every leaf to host memory before it returns, then writes on a
daemon thread.  NumPy has no bfloat16: a bf16 leaf is stored as its
uint16 bits with ``"bfloat16"`` in the manifest, and restored bit for
bit.  ``restore`` puts each leaf on the device (and in the dtype) of the
matching leaf of ``like``.

Across ranks (a started ``torch.distributed`` group of more than one):
``save`` writes from rank 0 only, of a tree that rank 0 holds whole (the
parameters and optimizer state of data parallelism), and every rank
waits at a barrier until the step is on disk; such a save is always
blocking.  ``restore`` with ``mesh`` and ``specs`` gives each rank its
block of each leaf (``sharding.rules.shard_leaf``), as JAX's elastic
restore puts each leaf on a new sharding: a checkpoint taken at one
world size restores at any other.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding.rules import shard_leaf
from repro_torch.tree import tree_flatten, tree_leaves

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]

_SHARD_BYTES = 512 * 1024 * 1024


def _host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(a NumPy copy of ``t`` on the host, the dtype name to record)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _rank_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def save(directory: str, step: int, tree, *, blocking: bool = True,
         extra_meta: Optional[dict] = None) -> threading.Thread | None:
    """Write ``tree`` at ``<directory>/step_<step>`` (atomic rename); across
    ranks, from rank 0, blocking, then a barrier."""
    rank, world = _rank_world()
    if world > 1:
        if rank == 0:
            _save(directory, step, tree, True, extra_meta)
        dist.barrier()
        return None
    return _save(directory, step, tree, blocking, extra_meta)


def _save(directory, step, tree, blocking, extra_meta):
    os.makedirs(directory, exist_ok=True)
    paths, leaves, _ = tree_flatten(tree)
    # snapshot to host BEFORE going async: the caller may go on and change
    # or free its tensors
    host = [_host(x) for x in leaves]

    def write():
        tmp = os.path.join(directory, f"step_{step}.tmp")
        final = os.path.join(directory, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": [], "shards": 0,
                    "extra": extra_meta or {}}
        shard, shard_bytes, shard_idx = {}, 0, 0

        def flush():
            nonlocal shard, shard_bytes, shard_idx
            if shard:
                with open(os.path.join(tmp, f"shard_{shard_idx}.npz"),
                          "wb") as f:
                    np.savez(f, **shard)
                    f.flush()
                    os.fsync(f.fileno())
                shard, shard_bytes = {}, 0
                shard_idx += 1

        for p, (arr, dtype) in zip(paths, host):
            key = p.replace("/", "__")
            manifest["leaves"].append(
                {"path": p, "key": key, "shard": shard_idx,
                 "dtype": dtype, "shape": list(arr.shape)})
            shard[key] = arr
            shard_bytes += arr.nbytes
            if shard_bytes >= _SHARD_BYTES:
                flush()
        flush()
        manifest["shards"] = shard_idx
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") \
                and os.path.exists(os.path.join(directory, name,
                                                "manifest.json")):
            steps.append(int(name.split("_", 1)[1]))
    return max(steps) if steps else None


def _leaf(arr: np.ndarray, dtype: str, like, spec=None,
          mesh=None) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if spec is not None:
        t = shard_leaf(t, spec, mesh)
    if isinstance(like, torch.Tensor):
        t = t.to(device=like.device, dtype=like.dtype)
    return t


def restore(directory: str, step: int, like, *, mesh=None, specs=None):
    """Load ``step`` into the structure of ``like`` (a tree of tensors):
    each leaf on the device and in the dtype of ``like``'s.  With
    ``mesh`` and ``specs`` (a tree of ``PartitionSpec`` like ``like``),
    each leaf is this rank's block under its spec: an elastic restore
    onto a new mesh."""
    folder = os.path.join(directory, f"step_{step}")
    with open(os.path.join(folder, "manifest.json")) as f:
        manifest = json.load(f)
    by_shard: dict[int, list] = {}
    for leaf in manifest["leaves"]:
        by_shard.setdefault(leaf["shard"], []).append(leaf)
    data: dict[str, tuple[np.ndarray, str]] = {}
    for sh, leaves in by_shard.items():
        with np.load(os.path.join(folder, f"shard_{sh}.npz")) as z:
            for leaf in leaves:
                data[leaf["path"]] = (z[leaf["key"]], leaf["dtype"])

    paths, like_leaves, unflatten = tree_flatten(like)
    if mesh is None or specs is None:
        return unflatten([_leaf(*data[p], ref)
                          for p, ref in zip(paths, like_leaves)])
    spec_leaves = tree_leaves(specs)
    if len(spec_leaves) != len(like_leaves):
        raise ValueError(f"{len(spec_leaves)} specs for "
                         f"{len(like_leaves)} leaves")
    return unflatten([
        _leaf(*data[p], ref, s, mesh)
        for p, ref, s in zip(paths, like_leaves, spec_leaves)])


@dataclasses.dataclass
class CheckpointManager:
    """Keep-last-k rotation + async handles (the production interface)."""
    directory: str
    keep: int = 3

    def __post_init__(self):
        self._pending: list[threading.Thread] = []

    def save(self, step: int, tree, *, blocking: bool = False,
             extra_meta: Optional[dict] = None):
        t = save(self.directory, step, tree, blocking=blocking,
                 extra_meta=extra_meta)
        if t is not None:
            self._pending.append(t)
        self._gc()

    def wait(self):
        for t in self._pending:
            t.join()
        self._pending.clear()

    def restore_latest(self, like, *, mesh=None, specs=None):
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore(self.directory, step, like, mesh=mesh,
                             specs=specs)

    def _gc(self):
        if _rank_world()[0] != 0:
            return
        steps = sorted(s for s in (
            int(n.split("_", 1)[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")))
        for s in steps[:-self.keep]:
            path = os.path.join(self.directory, f"step_{s}")
            if os.path.exists(os.path.join(path, "manifest.json")):
                shutil.rmtree(path, ignore_errors=True)
