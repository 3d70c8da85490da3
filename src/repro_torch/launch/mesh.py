"""Meshes of ranks: the port's counterpart of JAX's device meshes
(``repro.launch.mesh`` and ``repro.compat``'s ``make_mesh``/
``abstract_mesh``).

A ``Mesh`` names its axes and their sizes, as a JAX mesh does
(``mesh.shape[name]``, ``mesh.axis_names``), and places this process at
one coordinate on each.  Ranks are laid out row-major over the axes, as
``jax.make_mesh`` lays out devices, so the ranks that share every
coordinate but those of some axes form those axes' group.

- An abstract mesh (``abstract_mesh``, ``make_production_mesh``) has no
  process group.  ``sharding.rules`` reads it to work out specs, and
  ``sharding.rules.shard_leaf`` reads this process's coordinates from it.
- A live mesh (``make_mesh``, ``make_local_mesh``) also holds one
  ``torch.distributed`` process group for every non-empty set of its
  axes, built at once on every rank.  It runs the collectives that JAX
  names by axis (``psum``, ``all_gather``), with gradients.

The gradients follow one convention: every rank holds the same global
loss and differentiates it through the part of the graph it holds.
``psum`` sums in the forward and passes the gradient through (its
output feeds that common loss); ``fan_out`` is the identity in the
forward and sums the gradient over the axes (its input is replicated
over them, its consumers hold different parts); ``all_gather`` gives a
block's gradient back to the rank that owns it (the gathered whole
feeds the same computation on every rank of the axes); ``gather``
(FSDP's) reduce-scatters it instead (the whole feeds computations that
differ along the axes: other rows of the batch, other heads), in f32.
Gradients of leaves a rank holds whole are then this rank's share,
summed over the batch axes by the train step.  The sequence-parallel
residual stream also takes the whole sequence into a tensor-parallel
sub-layer through ``gather``, and adds ``scatter`` (a reduce-scatter;
the gradient all-gathered) and ``split`` (this rank's block of a tensor
the ranks hold alike; the gradient all-gathered).  Axes of size 1 cost
nothing in these two: no collective.

Every collective goes through one of the mesh's methods (``psum``,
``fan_out``, ``all_gather``, ``gather``, ``scatter``, ``split``,
``pmax``, ``all_reduce_``), in the forward and in each gradient's
backward.  While a ``recording()`` is open, each one appends an entry
(kind, result bytes, group size) to it: the kinds are XLA's names
(``all-reduce``, ``all-gather``, ``reduce-scatter``), and a group of one
rank, which moves nothing, appends none.  ``launch.cost_analysis``
turns the entries into wire bytes.

On an abstract mesh the same methods take shape-only tensors (a
``FakeTensor``, which carries no data) in count mode: they communicate
nothing, return a tensor of the shape and dtype the collective would,
and record the same entries as on a live mesh.  The dry-run
(``launch.dryrun``) traces one rank's program on an abstract mesh so.
A tensor with data on an abstract mesh raises, as it has no process
group to reduce over.

``init_ranks`` starts the process group: NCCL on ``cuda:LOCAL_RANK`` by
default, gloo when ``device="cpu"``.  Under ``torchrun`` it reads
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; with none set the process is
a world of one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.device import resolve_device
from repro_torch.sharding.rules import ShardingRules

__all__ = ["Mesh", "abstract_mesh", "make_mesh", "make_local_mesh",
           "make_production_mesh", "rules_for_mesh", "init_ranks",
           "shutdown_ranks"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over ranks; ``rank`` is this process's place on them.
    ``groups`` maps each non-empty tuple of axes (in mesh order) to the
    process group of this rank's ranks along them (empty: abstract).
    ``logs`` holds the open ``recording()``s."""
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict, repr=False)
    logs: list = dataclasses.field(default_factory=list, repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} against {self.axis_sizes}")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def coords(self) -> dict[str, int]:
        """This rank's coordinate on each axis (row-major layout)."""
        out, rest = {}, self.rank
        for name, n in reversed(tuple(zip(self.axis_names,
                                          self.axis_sizes))):
            out[name] = rest % n
            rest //= n
        return {name: out[name] for name in self.axis_names}

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        where = [self.axis_names.index(a) for a in axes]
        if where != sorted(set(where)):
            raise ValueError(f"axes {axes} are not distinct axes of "
                             f"{self.axis_names} in the mesh's order")
        return axes

    def axis_size(self, axes) -> int:
        """The number of blocks along ``axes`` (a name or a tuple)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's block along ``axes``, row-major over them: its
        place in the axes' group and in an ``all_gather`` over it."""
        idx, coords = 0, self.coords
        for a in self._axes(axes):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def _counts_only(self, t: torch.Tensor) -> bool:
        """Count mode: a shape-only ``t`` on an abstract mesh.  Any other
        tensor on an abstract mesh reaches ``group``, which raises."""
        return not self.groups and isinstance(t, FakeTensor)

    @property
    def device(self) -> torch.device:
        """This rank's device on a live mesh: its card under NCCL (the
        current CUDA device, which ``init_ranks`` sets), else the CPU."""
        if dist.get_backend(self.group(self.axis_names)) == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def group(self, axes):
        axes = self._axes(axes)
        if not self.groups:
            raise RuntimeError("an abstract mesh has no process groups; "
                               "build a live one with make_mesh")
        return self.groups[axes]

    @contextlib.contextmanager
    def recording(self):
        """A list that every collective run through this mesh while the
        context is open appends (kind, result bytes, group size) to."""
        log: list = []
        self.logs.append(log)
        try:
            yield log
        finally:
            self.logs.remove(log)

    def _record(self, kind: str, result_bytes: int, n: int):
        if n > 1:
            for log in self.logs:
                log.append((kind, result_bytes, n))

    # the three collectives every method is built from; in count mode
    # each leaves this rank's values where the others' would land
    def all_reduce_(self, y: torch.Tensor, axes, op=None) -> torch.Tensor:
        """``y`` reduced in place over the ranks of ``axes`` (a sum, or
        ``op``), without a gradient: the methods below, the train step's
        sum of gradients, the int8 all-reduce."""
        self._record("all-reduce", _nbytes(y), self.axis_size(axes))
        if not self._counts_only(y):
            dist.all_reduce(y, op=op or dist.ReduceOp.SUM,
                            group=self.group(axes))
        return y

    def _all_gather_into(self, out: torch.Tensor, x: torch.Tensor, axes):
        """``out`` [n * len(x), ...] <- the ranks' ``x`` in block order."""
        n = self.axis_size(axes)
        self._record("all-gather", _nbytes(out), n)
        if self._counts_only(x):
            out.view(n, *x.shape).copy_(x.expand(n, *x.shape))
        else:
            _gather_into(out, x, group=self.group(axes))
        return out

    def _reduce_scatter_into(self, out: torch.Tensor, x: torch.Tensor,
                             axes):
        """``out`` <- this rank's block (along dim 0) of the ranks' sum
        of ``x``."""
        self._record("reduce-scatter", _nbytes(out), self.axis_size(axes))
        if self._counts_only(x):
            block = out.shape[0]
            out.copy_(x.narrow(0, self.axis_index(axes) * block, block))
        else:
            _reduce_scatter(out, x, group=self.group(axes))
        return out

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum over the ranks of ``axes`` (JAX's ``lax.psum``); the
        gradient passes through."""
        return _Psum.apply(x, self, self._axes(axes))

    def fan_out(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``x``, replicated over ``axes``, as the input of computations
        that differ along them: its gradient is summed over ``axes``."""
        return _FanOut.apply(x, self, self._axes(axes))

    def all_gather(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The blocks of ``axes`` concatenated along ``dim`` in block
        order (JAX's tiled ``lax.all_gather``); the gradient's own block
        comes back."""
        return _AllGather.apply(x, self, self._axes(axes), dim)

    def gather(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The blocks of ``axes`` concatenated along ``dim``, as
        ``all_gather``; the gradient is reduce-scattered: summed over
        ``axes`` in f32 (one ``reduce_scatter``), this rank's block kept
        and cast to ``x``'s dtype.  FSDP's gather at use, and the
        sequence's at a tensor-parallel sub-layer's entry."""
        return _Gather.apply(x, self, self._axes(axes), dim)

    def scatter(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The sum over the ranks of ``axes`` of ``x``, of which this rank
        keeps its block along ``dim`` (one ``reduce_scatter`` in ``x``'s
        dtype; JAX's ``psum_scatter``); the gradient is all-gathered
        (every rank's block feeds the sum).  On axes of size 1, ``x``."""
        if self.axis_size(axes) == 1:
            return x
        return _Scatter.apply(x, self, self._axes(axes), dim)

    def split(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of ``x``, which every rank of
        ``axes`` holds alike; the gradient is all-gathered (each block
        of ``x`` feeds the loss on its own rank).  On axes of size 1,
        ``x``."""
        if self.axis_size(axes) == 1:
            return x
        return _Split.apply(x, self, self._axes(axes), dim)

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The elementwise maximum over the ranks of ``axes``, without a
        gradient."""
        y = x.detach().clone(memory_format=torch.contiguous_format)
        return self.all_reduce_(y, axes, dist.ReduceOp.MAX)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce_(
            x.clone(memory_format=torch.contiguous_format), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _FanOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(
            g.clone(memory_format=torch.contiguous_format), ctx.axes), \
            None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        n, index = mesh.axis_size(axes), mesh.axis_index(axes)
        x = x.contiguous()
        ctx.dim, ctx.index, ctx.block = dim, index, x.shape[dim]
        return torch.cat(_gathered_parts(mesh, x, axes, n), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.block, ctx.block),
                None, None, None)


# torch >= 2.13 names the tensor collectives *_single
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _gathered_parts(mesh, x, axes, n: int) -> list[torch.Tensor]:
    """The ``n`` ranks' blocks ``x`` of ``axes``, in block order (one
    ``all_gather`` into a list)."""
    parts = [torch.empty_like(x) for _ in range(n)]
    mesh._record("all-gather", n * _nbytes(x), n)
    if mesh._counts_only(x):
        for p in parts:
            p.copy_(x)
    else:
        dist.all_gather(parts, x, group=mesh.group(axes))
    return parts


def _gathered(x, mesh, axes, dim: int) -> torch.Tensor:
    """The blocks ``x`` of the ranks of ``axes`` concatenated along
    ``dim`` (one ``all_gather`` into a tensor)."""
    n = mesh.axis_size(axes)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0], *xm.shape[1:]), dtype=x.dtype,
                      device=x.device)
    mesh._all_gather_into(out, xm, axes)
    return out.movedim(0, dim).contiguous()


def _scattered(x, mesh, axes, dim: int, dtype) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` in ``dtype``, this
    rank's block along ``dim`` (one ``reduce_scatter``), cast back to
    ``x``'s dtype."""
    n = mesh.axis_size(axes)
    xm = x.movedim(dim, 0).to(dtype).contiguous()
    out = torch.empty((xm.shape[0] // n, *xm.shape[1:]), dtype=dtype,
                      device=x.device)
    mesh._reduce_scatter_into(out, xm, axes)
    return out.movedim(0, dim).to(x.dtype).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gathered(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_scattered(g, ctx.mesh, ctx.axes, ctx.dim, torch.float32),
                None, None, None)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _scattered(x, mesh, axes, dim, x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _gathered(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        n, index = mesh.axis_size(axes), mesh.axis_index(axes)
        block = x.shape[dim] // n
        return x.narrow(dim, index * block, block).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gathered(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def abstract_mesh(axis_sizes, axis_names, rank: int = 0) -> Mesh:
    """A mesh without process groups (``repro.compat.abstract_mesh``),
    seen from ``rank``."""
    return Mesh(tuple(axis_names), tuple(int(n) for n in axis_sizes), rank)


def make_mesh(axis_sizes, axis_names) -> Mesh:
    """A live mesh over the ranks of the started process group (see
    ``init_ranks``): one group for every non-empty tuple of axes, made
    in the same order on every rank, as ``new_group`` needs."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_ranks first")
    mesh = abstract_mesh(axis_sizes, axis_names, dist.get_rank())
    if mesh.size != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size} ranks in a world of "
                         f"{dist.get_world_size()}")
    ranks = list(range(mesh.size))
    everyone = [abstract_mesh(axis_sizes, axis_names, r).coords
                for r in ranks]
    for n_axes in range(1, len(mesh.axis_names) + 1):
        for axes in itertools.combinations(mesh.axis_names, n_axes):
            if len(axes) == len(mesh.axis_names):
                mesh.groups[axes] = dist.group.WORLD
                continue
            rest = [a for a in mesh.axis_names if a not in axes]
            parts: dict[tuple, list] = {}
            for r, c in zip(ranks, everyone):
                parts.setdefault(tuple(c[a] for a in rest), []).append(r)
            for members in parts.values():
                g = dist.new_group(members)
                if mesh.rank in members:
                    mesh.groups[axes] = g
    return mesh


def make_local_mesh() -> Mesh:
    """Every rank on ("data", "model") = (world, 1), as JAX's over all
    local devices."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_ranks first")
    return make_mesh((dist.get_world_size(), 1), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The TPU pods' (16, 16) ("data", "model") grid, or (2, 16, 16) with
    a leading "pod" axis: abstract, for working out specs."""
    if multi_pod:
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


def rules_for_mesh(mesh: Mesh, *, sp: bool = False, fsdp: bool = True,
                   kv_seq: tuple[str, ...] = ()) -> ShardingRules:
    batch = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    # FSDP stays inside a pod (over "data"): cross-pod traffic is then only
    # the gradient all-reduce
    return ShardingRules(batch=batch, model="model", sp=sp,
                         fsdp=("data",) if fsdp else (), kv_seq=kv_seq)


def init_ranks(device=None, *, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               init_method: Optional[str] = None) -> torch.device:
    """Start this process's process group and return its device.

    ``device`` None (or "cuda") is the card ``cuda:LOCAL_RANK`` with
    NCCL, and raises without one; "cpu" is gloo.  Without ``rank``, the
    rank, world size and local rank come from ``torchrun``'s variables
    (``init_method`` "env://"), or the process is a world of one with an
    in-process store.  Processes started otherwise (``spawn``) pass
    ``rank``, ``world_size`` and an ``init_method``; their local rank is
    their rank."""
    if rank is None:
        env = os.environ
        if "RANK" in env:
            rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
            local = int(env.get("LOCAL_RANK", rank))
            init_method = init_method or "env://"
        else:
            rank, world_size, local = 0, 1, 0
    else:
        local = rank
        if world_size is None or init_method is None:
            raise ValueError("a given rank needs world_size and "
                             "init_method")
    if device is not None and str(device) not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: ranks run on 'cuda' (NCCL) "
                         f"or 'cpu' (gloo)")
    dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend, kw["device_id"] = "nccl", dev
    else:
        backend = "gloo"
    if init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size, **kw)
    return dev


def shutdown_ranks():
    """Destroy the process group ``init_ranks`` started, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()
