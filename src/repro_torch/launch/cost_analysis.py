"""Collective traffic, roofline terms, bytes and peak memory of one rank's
traced program: the port's counterpart of ``repro.launch.hlo_analysis``.

JAX compiles each dry-run program and reads XLA's analyses of it: the
cost analysis (flops, bytes accessed), the memory analysis (argument,
output and temporary bytes) and the optimized HLO text, whose
collectives it parses.  The port compiles nothing.  It runs one rank's
program eagerly on shape-only tensors (``launch.dryrun``) and counts at
the source instead:

- **Collectives.** Every collective goes through ``launch.mesh.Mesh``,
  which records (kind, result bytes, group size) while a
  ``recording()`` is open, on an abstract mesh as on a live one.
  ``collective_bytes`` turns the entries into wire bytes with the ring
  formulas ``hlo_analysis`` uses, over the group size n:

    all-reduce       2 * size * (n-1)/n      (reduce-scatter + all-gather)
    all-gather       size_out * (n-1)/n
    reduce-scatter   size_out * (n-1)
    all-to-all       size * (n-1)/n
    collective-permute  size                  (point to point)

  These are the collectives the port runs, which are not the ones XLA
  would choose for the same specs.
- **Bytes.** ``Tally`` adds the operand and result bytes of every
  operator the trace dispatches (views and allocations, which move
  nothing, excluded), the kernels' operators
  (``kernels.work``) too.  Eager operators do not fuse, so this is an
  upper bound on what the card moves.
- **Peak memory.** ``Tally`` follows every storage alive during the
  trace, the inputs' too, rounded to the caching allocator's 512-byte
  blocks, and keeps the largest total: the counterpart of
  ``torch.cuda.max_memory_allocated`` over the same program on the card
  (the allocator's own cache and the libraries' workspaces aside).
  Where autograd's formulas differ between plain tensors and tensor
  subclasses, the card's way is counted: a gather's gradient is
  scattered into a fresh zero tensor in place on the card
  (``gather_backward``), out of place on a ``FakeTensor``, which would
  hold a second copy of the whole gradient, as large as the logits at
  the loss.

Roofline terms use H100 SXM constants (``HW``).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _op_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.tree import tree_leaves

__all__ = ["collective_bytes", "roofline_terms", "HW", "CollectiveStats",
           "Tally", "collective_bw", "NODE_CARDS"]

# hardware constants of one H100 SXM card (NVIDIA's H100 data sheet)
HW = {
    "peak_flops": 989e12,       # bf16 dense, tensor cores
    "hbm_bw": 3.35e12,          # bytes/s, HBM3
    # bytes/s a card sends on the wire in a ring collective:
    "nvlink_bw": 450e9,         # NVLink 4 inside a node: 900 GB/s both ways
    "ib_bw": 50e9,              # across nodes: one 400 Gb/s NDR NIC a card
}
# cards a node holds (DGX/HGX H100): the ranks of one NVLink domain
NODE_CARDS = 8

_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")
_ALLOC_BLOCK = 512              # the CUDA caching allocator's rounding
_aten = torch.ops.aten
# autograd's out-of-place scatters into a zero tensor it has just made,
# which it runs in place on plain tensors
# operators that move no bytes: allocations
_ALLOCATIONS = {_aten.empty.memory_format, _aten.empty_like.default,
                _aten.new_empty.default, _aten.empty_strided.default,
                _aten.new_empty_strided.default}
_IN_PLACE_ON_CARD = {_aten.scatter_add.default: (_aten.new_zeros.default,
                                                 _aten.zeros.default)}


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float                   # per-device bytes on the wire
    by_kind: Dict[str, float]
    counts: Dict[str, int]


def collective_bytes(entries) -> CollectiveStats:
    """Wire bytes of the (kind, result bytes, group size) entries a
    ``Mesh.recording()`` collected, by the ring formulas above."""
    by_kind: Dict[str, float] = {k: 0.0 for k in _KINDS}
    counts: Dict[str, int] = {k: 0 for k in _KINDS}
    for kind, size, n in entries:
        if kind == "all-reduce":
            wire = 2 * size * (n - 1) / max(n, 1)
        elif kind == "all-gather":
            wire = size * (n - 1) / max(n, 1)
        elif kind == "reduce-scatter":
            wire = size * (n - 1)          # size is the scattered output
        elif kind == "all-to-all":
            wire = size * (n - 1) / max(n, 1)
        else:                               # collective-permute
            wire = size
        by_kind[kind] += wire
        counts[kind] += 1
    return CollectiveStats(
        wire_bytes=sum(by_kind.values()), by_kind=by_kind, counts=counts)


def collective_bw(chips: int) -> float:
    """The wire rate of a card in a mesh of ``chips`` ranks laid out
    row-major, ``NODE_CARDS`` to a node: NVLink when the whole mesh fits
    in one node, else the NIC.  Both production meshes, (16, 16) and (2,
    16, 16), cross nodes on every axis: a "model" group is 16
    consecutive ranks (two nodes), a "data" or "pod" group takes one rank
    a node; a ring over a group is as slow as its slowest link."""
    return HW["nvlink_bw"] if chips <= NODE_CARDS else HW["ib_bw"]


def roofline_terms(*, hlo_flops: float, hlo_bytes: float,
                   collective_wire_bytes: float, chips: int,
                   model_flops: float) -> dict:
    """The three roofline times (seconds) + bottleneck + usefulness ratio,
    with ``hlo_analysis.roofline_terms``' keys.  ``hlo_flops`` and
    ``hlo_bytes`` are one rank's (the dry-run traces one rank's program);
    ``model_flops`` is the global analytic 6·N·D count, divided by
    ``chips``.  The wire rate is a card's, ``collective_bw(chips)``, in
    place of JAX's ICI links a chip."""
    t_compute = hlo_flops / HW["peak_flops"]
    t_memory = hlo_bytes / HW["hbm_bw"]
    t_collective = collective_wire_bytes / collective_bw(chips)
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    model_per_chip = model_flops / chips
    return {
        **terms,
        "dominant": dominant,
        "model_flops": model_flops,
        "useful_flops_ratio": model_per_chip / hlo_flops
        if hlo_flops else 0.0,
        "step_lower_bound_s": bound,
        "roofline_fraction": (model_per_chip / HW["peak_flops"]) / bound
        if bound > 0 else 0.0,
    }


def _rounded(nbytes: int) -> int:
    return -(-nbytes // _ALLOC_BLOCK) * _ALLOC_BLOCK


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Tally(TorchDispatchMode):
    """Over every operator dispatched while it is entered: ``accessed``,
    the operand and result bytes of each (views and allocations
    excluded); ``live`` and
    ``peak``, the bytes of the storages alive (those of ``inputs``, then
    of every result), each rounded up to 512 bytes."""

    def __init__(self, inputs=()):
        super().__init__()
        self.accessed = 0
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()    # storage -> (weakref, bytes)
        self._made = (None, lambda: None)     # the last op, its result
        for t in tree_leaves(inputs):
            if isinstance(t, torch.Tensor):
                self._track(t)

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = _rounded(st.nbytes())
        self._seen[st] = (weakref.ref(st, lambda _, n=n: self._free(n)), n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, n: int):
        self.live -= n

    def _release(self, t: torch.Tensor):
        """Count ``t``'s storage as freed now (its weakref dropped, so
        its later death frees nothing more)."""
        st = t.untyped_storage()
        _, n = self._seen[st]
        self._seen[st] = (None, 0)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        results = [t for t in _op_leaves(out)
                   if isinstance(t, torch.Tensor)]
        if not (func.is_view or func in _ALLOCATIONS):
            self.accessed += sum(
                _nbytes(t) for t in _op_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)) + sum(map(_nbytes, results))
        made, fresh = self._made
        if made in _IN_PLACE_ON_CARD.get(func, ()) and args[0] is fresh():
            self._release(args[0])      # the card writes into it instead
        for t in results:
            self._track(t)
        self._made = (func, weakref.ref(results[0]) if results
                      else lambda: None)
        return out
