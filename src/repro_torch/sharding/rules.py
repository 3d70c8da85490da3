"""Logical-axis -> mesh-axis sharding rules (``repro.sharding.rules``).

Every parameter leaf is assigned *logical* axes by name (vocab / heads /
kv / ffn / expert / inner); logical axes map to mesh axes through the
rule table; an assignment whose dimension the mesh axis does not divide
falls back to replication, and when two logical axes map to one mesh
axis the first listed wins.  The tables are JAX's, copied.

A spec is a ``PartitionSpec``: one entry per dim, a mesh axis name, a
tuple of names, or None.  ``shard_leaf`` cuts this rank's block of a
global tensor by its spec (JAX's ``named_shardings`` and ``device_put``);
``LeafCutter`` does it leaf by leaf as ``init_params`` draws them.
``spec_axes``, ``fsdp_dims`` and ``reduced_axes`` read a spec.

The ``Constrainer`` is JAX's activation constrainer seen from one rank:
each rank already holds only its rows, so its constraints are
identities.  It carries what the port's code needs instead: the mesh,
the rules, the batch axes the rows are split over (``batch_axes``, by
``batch_pspec``), ``ep_context`` for MoE's expert parallelism, and,
given the parameters' specs, what runs them at run time, as GSPMD runs
JAX's specs: ``gather_fsdp``/``gather_block`` gather a leaf's FSDP dims
at use (to its tensor-parallel block), and ``tp`` hands a module a
``TensorParallel`` view of its leaves' model-axis cuts.  Under
``rules.sp`` it makes JAX's sequence constraint real: ``seq`` hands the
forward a ``SequenceParallel`` view (the residual stream is the rank's
block of the sequence between sub-layers), where JAX's ``__call__``
would split the sequence.  Given ``cache_pspecs``' specs
(``cache_specs``), a decode cache is this rank's block and ``kv_seq``
says which block of positions.  Axes of size 1 cost nothing: no
gather, no collective.  Nothing here imports ``torch.distributed``:
meshes may be abstract.
"""
from __future__ import annotations

import dataclasses
import math
import types
from typing import Optional

import torch

__all__ = ["ShardingRules", "PartitionSpec", "P", "param_pspecs",
           "batch_pspec", "cache_pspecs", "Constrainer", "make_constrain",
           "shard_leaf", "block_shape", "spec_axes", "fsdp_dims",
           "reduced_axes", "gather_dim", "gather_fsdp", "TensorParallel",
           "SequenceParallel", "KVSeq", "LeafCutter", "enter", "leave"]


class PartitionSpec:
    """One entry per dim: a mesh axis name, a tuple of names, or None.
    A one-name tuple is kept as the name, as JAX normalises it.  Not a
    tuple, so a tree of specs flattens to one leaf a spec."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, PartitionSpec) and \
            self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    batch: tuple[str, ...] = ("data",)       # ("pod","data") multi-pod
    model: str = "model"
    # FSDP/ZeRO-3: the non-TP dim of every 2-D weight shards over these
    # axes (gathered per layer at use time).  () disables.
    fsdp: tuple[str, ...] = ("data",)
    # FSDP on the expert-stacked MoE weights too
    expert_fsdp: bool = True
    # sequence-parallel residual stream (train/prefill activations)
    sp: bool = False
    # shard the decode KV cache's sequence dim over these axes
    kv_seq: tuple[str, ...] = ()

    def axis_size(self, mesh, name) -> int:
        if isinstance(name, tuple):
            out = 1
            for n in name:
                out *= mesh.shape[n]
            return out
        return mesh.shape[name]


# logical axis name -> rule field providing the mesh axis
_LOGICAL = {
    "vocab": "model",
    "heads": "model",
    "kv": "model",
    "ffn": "model",
    "expert": "model",
    "inner": "model",
    "fsdp": "fsdp",
}

# parameter leaf name -> logical axes per dim (trailing dims; leading
# stacked-block dims are padded with None); the first listed logical axis
# wins when two map to the same mesh axis
_PARAM_AXES = {
    "embed": {2: ("vocab", "fsdp"), 3: (None, "vocab", "fsdp")},
    "head": {2: ("fsdp", "vocab"), 3: (None, "fsdp", "vocab")},
    "wq": {2: ("fsdp", "heads")},
    "wk": {2: ("fsdp", "kv")},
    "wv": {2: ("fsdp", "kv")},
    "wo": {2: ("heads", "fsdp")},
    "bq": {1: ("heads",)},
    "bk": {1: ("kv",)},
    "bv": {1: ("kv",)},
    "router": {2: (None, "expert")},
    # MoE expert-stacked weights: EP over the expert dim + FSDP inside
    "gate": {3: ("expert", "fsdp", "ffn"), 2: ("fsdp", "ffn")},
    "up": {3: ("expert", "fsdp", "ffn"), 2: ("fsdp", "ffn")},
    "down": {3: ("expert", "ffn", "fsdp"), 2: ("ffn", "fsdp")},
    # Mamba
    "in_proj": {2: ("fsdp", "inner")},
    "conv_w": {2: ("inner", None)},
    "conv_b": {1: ("inner",)},
    "x_proj": {2: ("inner", "fsdp")},
    "dt_proj": {2: ("fsdp", "inner")},
    "dt_bias": {1: ("inner",)},
    "A_log": {2: ("inner", None)},
    "D": {1: ("inner",)},
    "out_proj": {2: ("inner", "fsdp")},
}


def _map_with_keys(fn, tree, keys=()):
    """``fn(keys, leaf)`` over a tree of dicts, lists and tuples; ``keys``
    holds the dict keys from the root (list and tuple indices are not
    keys, as JAX's ``DictKey`` entries are not)."""
    if isinstance(tree, dict):
        return {k: _map_with_keys(fn, v, keys + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_keys(fn, v, keys) for v in tree)
    if tree is None:
        return None
    return fn(keys, tree)


def _mesh_axis_for(rules: ShardingRules, logical: Optional[str]):
    if logical is None:
        return None
    axis = getattr(rules, _LOGICAL[logical])
    if isinstance(axis, tuple):
        return axis if axis else None
    return axis


def _spec_for_leaf(keys, leaf, mesh, rules: ShardingRules) -> P:
    name = keys[-1] if keys else ""
    ndim = len(leaf.shape)
    lead = 1 if "blocks" in keys else 0     # stacked num_blocks axis
    table = _PARAM_AXES.get(name)
    if table is None or (ndim - lead) not in table:
        return P()
    axes = table[ndim - lead]
    if (not rules.expert_fsdp and ndim - lead == 3
            and name in ("gate", "up", "down")):
        axes = tuple(a if a != "fsdp" else None for a in axes)
    spec = [None] * lead
    used: set = set()                       # a mesh axis shards ONE dim
    for dim, logical in zip(leaf.shape[lead:], axes):
        mesh_axis = _mesh_axis_for(rules, logical)
        flat = mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)
        if (mesh_axis is not None and not (set(flat) & used)
                and dim % rules.axis_size(mesh, mesh_axis) == 0):
            spec.append(mesh_axis)
            used.update(flat)
        else:
            spec.append(None)               # divisibility / conflict
    return P(*spec)


def param_pspecs(params_shape, mesh, rules: ShardingRules):
    """A tree of ``PartitionSpec`` matching a params tree (leaves need
    only ``.shape``)."""
    return _map_with_keys(
        lambda keys, leaf: _spec_for_leaf(keys, leaf, mesh, rules),
        params_shape)


def batch_pspec(mesh, rules: ShardingRules, ndim: int,
                batch_size: int) -> P:
    """Input batch arrays [B, S, ...]: B over the batch axes (those of
    size > 1 that divide what is left of it, in order), rest replicated."""
    axes = []
    for a in rules.batch:
        size = mesh.shape[a]
        if batch_size % size == 0 and size > 1:
            axes.append(a)
            batch_size //= size
    lead = tuple(axes) if axes else None
    return P(lead, *([None] * (ndim - 1)))


def cache_pspecs(cfg, mesh, rules: ShardingRules, batch: int,
                 cache_shapes) -> dict:
    """Specs for decode caches (``transformer.init_block_caches``'s
    layout): attention KV [nb, B, Smax, K, hd] with batch over the batch
    axes that divide it, sequence over ``rules.kv_seq``, kv heads over the
    model axis when divisible; Mamba conv/h with batch and inner over the
    model axis."""
    def spec(keys, leaf):
        name = keys[-1] if keys else ""
        ndim = len(leaf.shape)
        b_axes = [a for a in rules.batch
                  if batch % mesh.shape[a] == 0 and mesh.shape[a] > 1]
        b_spec = tuple(b_axes) if b_axes else None
        if name in ("k", "v") and ndim == 5:
            smax = leaf.shape[2]
            seq_ok = rules.kv_seq and \
                smax % rules.axis_size(mesh, tuple(rules.kv_seq)) == 0
            seq_spec = tuple(rules.kv_seq) if seq_ok else None
            kv = leaf.shape[3]
            kv_spec = rules.model if (
                kv % mesh.shape[rules.model] == 0
                and rules.model not in (seq_spec or ())
                and not seq_ok) else None
            return P(None, b_spec, seq_spec, kv_spec, None)
        if name == "conv" and ndim == 4:
            di = leaf.shape[3]
            m = rules.model if di % mesh.shape[rules.model] == 0 else None
            return P(None, b_spec, None, m)
        if name == "h" and ndim == 4:
            di = leaf.shape[2]
            m = rules.model if di % mesh.shape[rules.model] == 0 else None
            return P(None, b_spec, m, None)
        return P()

    return _map_with_keys(spec, cache_shapes)


def _flat(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: P, mesh=None) -> tuple[str, ...]:
    """The mesh axes ``spec`` cuts a dim over, in dim order; with
    ``mesh``, only those of size > 1 (the ones that split anything)."""
    return tuple(a for e in spec for a in _flat(e)
                 if mesh is None or mesh.shape[a] > 1)


def fsdp_dims(spec: P, rules: ShardingRules
              ) -> list[tuple[int, tuple[str, ...]]]:
    """(dim, axes) of each dim of ``spec`` cut over the FSDP axes."""
    fsdp = tuple(rules.fsdp)
    return [(d, _flat(e)) for d, e in enumerate(spec)
            if fsdp and _flat(e) == fsdp]


def reduced_axes(spec: P, mesh, rules: ShardingRules,
                 batch_axes) -> tuple[str, ...]:
    """The batch axes over which ``gather_fsdp``'s backward has already
    summed a leaf's gradient: its FSDP axes of size > 1 that the rows
    are split over."""
    out = []
    for _, axes in fsdp_dims(spec, rules):
        out.extend(a for a in axes if mesh.shape[a] > 1 and a in batch_axes)
    return tuple(out)


def gather_dim(leaf: torch.Tensor, axes, dim: int, mesh,
               batch_axes=()) -> torch.Tensor:
    """``leaf``'s dim ``dim``, cut into blocks row-major over ``axes``
    (a spec's entry), gathered whole.  Over the axes the batch's rows are
    split over, the gradient is reduce-scattered (``Mesh.gather``: the
    whole feeds other rows on each rank); over the others, whose ranks
    hold the same rows, each rank keeps its own block of it
    (``Mesh.all_gather``).  When both kinds are cut, the all-gather runs
    first and the gather second, which leaves the blocks in the order of
    the gathered axes' indices; they are then put back in the row-major
    order over ``axes``, JAX's.  Axes of size 1 are skipped."""
    live = tuple(a for a in _flat(axes) if mesh.shape[a] > 1)
    split = tuple(a for a in live if a in batch_axes)
    same = tuple(a for a in live if a not in batch_axes)
    if same:
        leaf = mesh.all_gather(leaf, same, dim)
    if split:
        leaf = mesh.gather(leaf, split, dim)
    order = split + same
    if order != live:
        sizes = [mesh.shape[a] for a in order]
        x = leaf.movedim(dim, 0)
        x = x.reshape(*sizes, x.shape[0] // math.prod(sizes), *x.shape[1:])
        x = x.permute(*[order.index(a) for a in live],
                      *range(len(sizes), x.dim()))
        leaf = x.reshape(-1, *x.shape[len(sizes) + 1:]).movedim(0, dim) \
            .contiguous()
    return leaf


def gather_fsdp(leaf: torch.Tensor, spec: P, mesh, rules: ShardingRules,
                batch_axes=()) -> torch.Tensor:
    """``leaf``, this rank's block under ``spec``, with its FSDP dims
    gathered (``gather_dim`` over each): the block it has under tensor
    parallelism alone.  ``batch_axes``: the axes the rows are split
    over."""
    for dim, axes in fsdp_dims(spec, rules):
        leaf = gather_dim(leaf, axes, dim, mesh, batch_axes)
    return leaf


class TensorParallel:
    """One module's leaves seen from a rank of the model axis (size >
    1): ``specs`` maps each leaf's name to its spec (a stacked leaf's
    without the block dim), ``index`` is this rank's block.  ``cut``
    reads whether a leaf's dim is split over the model axis: a module
    computes on its block of a cut leaf and on the whole of one that
    fell back to replication.  ``fan_out`` and ``psum`` are the mesh's
    over the model axis; ``whole`` gathers a cut leaf whole."""

    def __init__(self, mesh, axis: str, specs: dict):
        self.mesh, self.axis, self.specs = mesh, axis, specs
        self.size = mesh.shape[axis]
        self.index = mesh.axis_index(axis)

    def cut(self, name: str, dim: int) -> bool:
        spec = self.specs.get(name)
        return spec is not None and dim < len(spec) and \
            self.axis in _flat(spec[dim])

    def fan_out(self, x):
        return self.mesh.fan_out(x, self.axis)

    def psum(self, x):
        return self.mesh.psum(x, self.axis)

    def whole(self, w, name: str, *, differ: bool):
        """Leaf ``name`` (``w``, this rank's block) whole.  ``differ``:
        the whole feeds computations that differ over the model ranks,
        so its gradient is summed over them (``Mesh.gather`` of a cut
        leaf, ``fan_out`` of a whole one); else every model rank
        computes alike and keeps its own block of the gradient."""
        cut = [d for d in range(w.dim()) if self.cut(name, d)]
        for d in cut:
            w = (self.mesh.gather if differ else self.mesh.all_gather)(
                w, self.axis, d)
        if differ and not cut:
            w = self.fan_out(w)
        return w


class SequenceParallel:
    """The residual stream's sequence split over the model axis (JAX's
    ``sp``, Megatron's sequence parallelism), seen from one rank: between
    sub-layers it holds its block [B, S/m, D] of the sequence (block
    ``index`` of ``size``).  A tensor-parallel sub-layer takes the whole
    sequence through ``gather`` (its gradient reduce-scattered in f32:
    the ranks' heads and channels differ) and ends in ``scatter`` (a
    reduce-scatter over the sequence in place of the psum).  A
    sub-layer every model rank computes alike (leaves whole) takes it
    through ``all_gather`` and keeps its block through ``split``.
    ``fan_out`` is for a whole leaf applied to the rank's block (the
    norms' scales): its gradient is summed over the model ranks, in the
    leaf's dtype (so ``transformer`` fans out the f32 copy of a bf16
    scale: one rounding of the sum, as on one rank)."""

    def __init__(self, mesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.size = mesh.shape[axis]
        self.index = mesh.axis_index(axis)

    def gather(self, x):
        return self.mesh.gather(x, self.axis, 1)

    def scatter(self, x):
        return self.mesh.scatter(x, self.axis, 1)

    def all_gather(self, x):
        return self.mesh.all_gather(x, self.axis, 1)

    def split(self, x):
        return self.mesh.split(x, self.axis, 1)

    def fan_out(self, w):
        return self.mesh.fan_out(w, self.axis)


def enter(x, tp: Optional[TensorParallel], sp: Optional[SequenceParallel]):
    """A sub-layer's input across the model axis, the one rule every
    sub-layer follows.  ``tp``: the sub-layer's ``TensorParallel`` view,
    None when every model rank computes it whole and alike; ``sp``: the
    ``SequenceParallel`` view, None when the residual stream holds the
    whole sequence.  Under ``tp`` the input fans out (``sp``: the
    sequence is gathered, its gradient reduce-scattered); computed
    alike, it is all-gathered over the sequence (``sp``) or taken as it
    is."""
    if tp is None:
        return x if sp is None else sp.all_gather(x)
    return tp.fan_out(x) if sp is None else sp.gather(x)


def leave(y, tp: Optional[TensorParallel], sp: Optional[SequenceParallel]):
    """A sub-layer's output across the model axis (``enter``'s
    counterpart): under ``tp`` the ranks' partial outputs are psummed
    (``sp``: reduce-scattered over the sequence); computed alike, the
    rank keeps its block of the sequence (``sp``) or the whole."""
    if tp is None:
        return y if sp is None else sp.split(y)
    return tp.psum(y) if sp is None else sp.scatter(y)


class KVSeq:
    """A decode cache's positions cut over ``axes`` (``rules.kv_seq``):
    this rank holds block ``index`` of ``n`` (row-major over the axes,
    ``Mesh.axis_index``'s order and JAX's for a tuple of mesh axes);
    ``pmax`` and ``psum`` reduce the decode attention's partials over
    the blocks."""

    def __init__(self, mesh, axes: tuple):
        self.mesh, self.axes = mesh, axes
        self.n = mesh.axis_size(axes)
        self.index = mesh.axis_index(axes)

    def pmax(self, x):
        return self.mesh.pmax(x, self.axes)

    def psum(self, x):
        return self.mesh.psum(x, self.axes)


def _block_spec(spec: P) -> P:
    return P(*spec.entries[1:])


class Constrainer:
    """JAX's activation constrainer on one rank: ``__call__``,
    ``moe_buf``, ``moe_tok`` and ``logits`` are identities, since a rank
    holds only its rows already.  ``batch_axes`` names the axes the
    batch's rows are split over (``batch_pspec`` at ``batch_size``, the
    rows of one forward; () when every rank holds them all).

    ``param_specs`` (a tree like the parameters, ``param_pspecs`` of
    their global shapes) says that each leaf is this rank's block under
    its spec: the modules then gather FSDP dims at use and compute on
    their tensor-parallel blocks.  Without it every leaf is whole.

    ``rules.sp`` splits the residual stream's sequence over the model
    axis (``seq``).  ``cache_specs`` (``cache_pspecs`` of the global
    caches, a tree like ``init_cache``'s) says that each decode cache is
    this rank's block under its spec (``kv_seq``)."""

    def __init__(self, mesh, rules: ShardingRules, batch_size: int,
                 param_specs=None, cache_specs=None):
        self.mesh = mesh
        self.rules = rules
        lead = batch_pspec(mesh, rules, 1, batch_size)[0]
        self.batch_axes = () if lead is None else (
            lead if isinstance(lead, tuple) else (lead,))
        self.param_specs = param_specs
        self.block_specs = None
        if param_specs is not None and "blocks" in param_specs:
            self.block_specs = _map_with_keys(
                lambda keys, s: _block_spec(s), param_specs["blocks"])
        self.cache_specs = cache_specs
        self.cache_block_specs = None if cache_specs is None else \
            _map_with_keys(lambda keys, s: _block_spec(s), cache_specs)

    def seq_axis(self, seq_len: int) -> Optional[str]:
        """The axis the residual stream's sequence of ``seq_len`` is split
        over: the model axis under ``rules.sp`` when it is larger than 1
        and divides ``seq_len`` (else None, JAX's fallback: the sequence
        stays whole)."""
        m = self.rules.model
        size = self.mesh.shape[m]
        if self.rules.sp and size > 1 and seq_len % size == 0:
            return m
        return None

    def seq(self, seq_len: int) -> Optional[SequenceParallel]:
        """The ``SequenceParallel`` view of a forward over ``seq_len``
        positions, or None when ``seq_axis`` is None."""
        axis = self.seq_axis(seq_len)
        return None if axis is None else SequenceParallel(self.mesh, axis)

    def kv_seq(self, spec: P) -> Optional[KVSeq]:
        """The ``KVSeq`` view of a KV cache block whose spec (without the
        block dim: [B, Smax, K, hd]) is ``spec``: its positions' axes of
        size > 1, or None when they are not cut."""
        axes = tuple(a for a in _flat(spec[1]) if self.mesh.shape[a] > 1)
        return KVSeq(self.mesh, axes) if axes else None

    def __call__(self, x):
        return x

    def moe_buf(self, x):
        return x

    def moe_tok(self, x):
        return x

    def logits(self, x):
        return x

    def ep_context(self):
        """(mesh, batch_axes, model_axis_size) when expert parallelism
        applies (model axis > 1); None on trivial meshes."""
        m = self.mesh.shape[self.rules.model]
        if m <= 1:
            return None
        return self.mesh, self.rules.batch, m

    def gather_fsdp(self, leaf, spec: P):
        return gather_fsdp(leaf, spec, self.mesh, self.rules,
                           self.batch_axes)

    def gather_block(self, block: dict, specs: dict) -> dict:
        """Every leaf of one block (a nested dict like ``specs``) with its
        FSDP dims gathered."""
        return {k: self.gather_block(v, specs[k]) if isinstance(v, dict)
                else self.gather_fsdp(v, specs[k]) for k, v in block.items()}

    def tp(self, specs: Optional[dict]) -> Optional[TensorParallel]:
        """A module's ``TensorParallel`` view (``specs``: its leaves'
        specs), or None when the model axis is 1 or no specs are
        carried: the module then runs as on one rank."""
        if specs is None or self.mesh.shape[self.rules.model] <= 1:
            return None
        return TensorParallel(self.mesh, self.rules.model, specs)


def make_constrain(mesh, rules: ShardingRules, batch_size: int,
                   param_specs=None, cache_specs=None):
    return Constrainer(mesh, rules, batch_size, param_specs, cache_specs)


class LeafCutter:
    """Cuts each parameter leaf to this rank's block as ``init_params``
    draws it (``shard=``), so no whole model is ever held, and records
    its spec: ``specs`` ends as ``param_pspecs`` of the global
    parameters.  A leaf whose spec splits nothing (every axis of size 1)
    is kept as drawn."""

    def __init__(self, mesh, rules: ShardingRules):
        self.mesh, self.rules = mesh, rules
        self.specs: dict = {}

    def __call__(self, keys: tuple, leaf: torch.Tensor, lead: int = 0):
        """``leaf`` at ``keys`` (dict keys from the root); ``lead`` > 0:
        it is one block of a leaf stacked over ``lead`` blocks."""
        shape = ((lead,) if lead else ()) + tuple(leaf.shape)
        spec = _spec_for_leaf(keys, types.SimpleNamespace(shape=shape),
                              self.mesh, self.rules)
        node = self.specs
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = spec
        mine = _block_spec(spec) if lead else spec
        if not spec_axes(mine, self.mesh):
            return leaf
        return shard_leaf(leaf, mine, self.mesh)


def block_shape(shape, spec: P, mesh) -> tuple[int, ...]:
    """The shape of a rank's block of a global ``shape`` under ``spec``;
    raises when a cut dim does not split evenly or an axis cuts two
    dims."""
    out, used = list(shape), []
    for dim, entry in enumerate(spec):
        axes = _flat(entry)
        if set(axes) & set(used):
            raise ValueError(f"{spec} cuts two dims over one axis")
        used.extend(axes)
        n = mesh.axis_size(entry) if axes else 1
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"into {n} blocks")
        out[dim] //= n
    return tuple(out)


def shard_leaf(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec``: each
    dim named in the spec is cut into equal blocks along its axes and the
    rank's (``mesh.axis_index``) is kept, as a tensor of its own."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n, i = mesh.axis_size(entry), mesh.axis_index(entry)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split into {n} blocks")
        size = x.shape[dim] // n
        x = x.narrow(dim, i * size, size)
    return x.clone(memory_format=torch.contiguous_format)
