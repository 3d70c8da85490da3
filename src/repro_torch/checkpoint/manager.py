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
``save`` writes from rank 0 only, and every rank waits at a barrier
until the step is on disk; such a save is always blocking.  Without
specs rank 0 holds the tree whole (the parameters and optimizer state
of data parallelism).  With ``mesh`` and ``specs`` each leaf is this
rank's block under its spec: rank 0 assembles each leaf whole in host
memory, one leaf at a time, from the block of the first rank that holds
each (sent to it over the world group), and writes it as it goes, in
the layout of a whole tree, as JAX writes each global array; no card
ever holds more than one block of a leaf beside its own.  ``restore``
reads leaf by leaf; with ``mesh`` and ``specs`` it gives each rank its
block of each leaf (``sharding.rules.shard_leaf``), as JAX's elastic
restore puts each leaf on a new sharding: a checkpoint taken on one
mesh restores on any other, or whole.
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

from repro_torch.sharding.rules import shard_leaf, spec_axes
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
         extra_meta: Optional[dict] = None, mesh=None,
         specs=None) -> threading.Thread | None:
    """Write ``tree`` at ``<directory>/step_<step>`` (atomic rename); across
    ranks, from rank 0, blocking, then a barrier.  With ``mesh`` and
    ``specs`` (a tree of ``PartitionSpec`` like ``tree``), each leaf is
    this rank's block and the whole leaves are written."""
    rank, world = _rank_world()
    if world > 1:
        if specs is not None:
            paths, leaves, _ = tree_flatten(tree)
            host = _gathered(leaves, tree_leaves(specs), mesh)
            if rank == 0:
                _save(directory, step, paths, host, True, extra_meta)
            else:
                for _ in host:      # send this rank's blocks
                    pass
        elif rank == 0:
            paths, leaves, _ = tree_flatten(tree)
            _save(directory, step, paths, map(_host, leaves), True,
                  extra_meta)
        dist.barrier()
        return None
    paths, leaves, _ = tree_flatten(tree)
    if blocking:
        return _save(directory, step, paths, map(_host, leaves), True,
                     extra_meta)
    # snapshot to host BEFORE going async: the caller may go on and change
    # or free its tensors
    return _save(directory, step, paths, [_host(x) for x in leaves], False,
                 extra_meta)


def _block_index(spec, mesh, rank: int) -> tuple[int, ...]:
    """The block of each dim that ``rank`` holds under ``spec``."""
    from repro_torch.launch.mesh import abstract_mesh
    at = abstract_mesh(mesh.axis_sizes, mesh.axis_names, rank)
    return tuple(0 if e is None else at.axis_index(e) for e in spec)


def _gathered(leaves, specs, mesh):
    """Each leaf whole on rank 0's host (NumPy, as ``_host``), one at a
    time: a generator that every rank runs through, in step, for the
    sends; on the other ranks it yields None."""
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} specs for {len(leaves)} leaves")
    rank = mesh.rank
    for x, spec in zip(leaves, specs):
        if not spec_axes(spec, mesh):
            yield _host(x) if rank == 0 else None
            continue
        x = x.detach().contiguous()
        seen, out, name = set(), None, None
        if rank == 0:
            shape = [n * mesh.axis_size(e) if e is not None else n
                     for n, e in zip(x.shape, spec)]
            first, name = _host(x)
            out = np.empty(shape, dtype=first.dtype)
            buf = torch.empty_like(x)
        for src in range(mesh.size):
            idx = _block_index(spec, mesh, src)
            if idx in seen:
                continue
            seen.add(idx)
            if src == rank and rank != 0:
                dist.send(x, dst=0)
            if rank != 0:
                continue
            if src == 0:
                block = first
            else:
                dist.recv(buf, src=src)
                block = _host(buf)[0]
            out[tuple(slice(i * n, (i + 1) * n)
                      for i, n in zip(idx, x.shape))] = block
        yield (out, name) if rank == 0 else None


def _save(directory, step, paths, host, blocking, extra_meta):
    """Write ``host``'s (array, dtype name) pairs at ``paths``; ``host``
    may be a generator, consumed while writing."""
    os.makedirs(directory, exist_ok=True)

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
    each leaf on the device and in the dtype of ``like``'s, read one at a
    time.  With ``mesh`` and ``specs`` (a tree of ``PartitionSpec`` like
    ``like``), each leaf is this rank's block under its spec: an elastic
    restore onto a new mesh."""
    folder = os.path.join(directory, f"step_{step}")
    with open(os.path.join(folder, "manifest.json")) as f:
        manifest = json.load(f)
    where = {leaf["path"]: leaf for leaf in manifest["leaves"]}
    paths, like_leaves, unflatten = tree_flatten(like)
    spec_leaves = [None] * len(like_leaves)
    if mesh is not None and specs is not None:
        spec_leaves = tree_leaves(specs)
        if len(spec_leaves) != len(like_leaves):
            raise ValueError(f"{len(spec_leaves)} specs for "
                             f"{len(like_leaves)} leaves")
    files: dict[int, np.lib.npyio.NpzFile] = {}
    try:
        out = []
        for p, ref, s in zip(paths, like_leaves, spec_leaves):
            leaf = where[p]
            if leaf["shard"] not in files:
                files[leaf["shard"]] = np.load(
                    os.path.join(folder, f"shard_{leaf['shard']}.npz"))
            arr = files[leaf["shard"]][leaf["key"]]
            out.append(_leaf(arr, leaf["dtype"], ref, s, mesh))
            del arr
    finally:
        for z in files.values():
            z.close()
    return unflatten(out)


@dataclasses.dataclass
class CheckpointManager:
    """Keep-last-k rotation + async handles (the production interface)."""
    directory: str
    keep: int = 3
    # a sharded tree's mesh and specs, for every save and restore
    mesh: object = None
    specs: object = None

    def __post_init__(self):
        self._pending: list[threading.Thread] = []

    def save(self, step: int, tree, *, blocking: bool = False,
             extra_meta: Optional[dict] = None):
        t = save(self.directory, step, tree, blocking=blocking,
                 extra_meta=extra_meta, mesh=self.mesh, specs=self.specs)
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
        if mesh is None and specs is None:
            mesh, specs = self.mesh, self.specs
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
