"""Top-k MoE with sort-based capacity dispatch (``repro.models.moe``'s
single-device path in PyTorch).

Routing: an f32 softmax router, top-k experts per token, then a stable
sort of the (token, expert) pairs by expert; each pair's rank within its
expert is clamped at a static capacity and the pair is written into a
dense [E, C, D] buffer (an overflow row takes the dropped pairs); a
batched expert SwiGLU; and the weighted outputs go back to their tokens.

Two choices keep the port deterministic and equal to JAX:
- top-k is the first ``k`` of a stable descending sort, so tied
  probabilities give the lower expert first, as ``jax.lax.top_k`` does;
- the combine does not scatter-add (whose CUDA atomics add in no fixed
  order): every token has exactly ``k`` pairs, so the outputs are
  gathered back to ``[T, k, D]`` through the inverse of the sort and
  summed over ``k`` in ascending expert order, the order in which JAX's
  scatter meets them.

Dropped pairs (capacity overflow) contribute zero; the token's other
top-k weights still apply, as in GShard/Switch.

Across ranks (``constrain`` from ``sharding.rules.make_constrain`` on a
live mesh), a rank holds its rows of the batch:
- with a model axis of 1 (data parallelism), ``moe_block`` routes the
  global batch, as JAX's program does under GSPMD: capacity from the
  global token count, and a pair's place in its expert's queue counts
  the earlier pairs to that expert on every rank (the ranks' counts are
  all-gathered once a layer; rank r holds the rows before rank r+1's);
- with a model axis larger than 1 that divides the experts,
  ``moe_block_ep`` runs JAX's ``shard_map`` expert parallelism;
- with a model axis larger than 1 that does not divide the experts,
  JAX falls through to its reference path, which GSPMD runs on the
  leaves ``param_pspecs`` cut: ``moe_block`` routes as with a model
  axis of 1, and each model rank runs its ``ffn`` block of every expert
  when ``d_ff`` divides the axis (a psum over it sums the shares), else
  the whole layer.

In all, the load-balance terms ``me`` and ``ce`` are averaged over the
batch axes before their product, and ``dropped_frac`` counts every
rank's pairs.  Under sequence parallelism (``sp``), x is the rank's
block of the sequence: the whole sequence is gathered over the model
axis at entry, so routing and capacity are those of the whole, and the
rank keeps its block of the output (``moe_block_ep`` reduce-scatters
it over the sequence in place of its psum).
"""
from __future__ import annotations

import types

import torch

from repro_torch.core.segments import segment_rank
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, swiglu
from repro_torch.sharding.rules import (TensorParallel, enter, gather_dim,
                                        leave, param_pspecs)

__all__ = ["init_moe", "moe_block", "moe_block_ep", "moe_capacity",
           "top_k"]


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Static per-expert capacity: ceil(T*k/E * factor), a multiple of 8."""
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    cap = int(n_tokens * k / e * cfg.capacity_factor) + 1
    return max(8, (cap + 7) // 8 * 8)


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> dict:
    """Router in f32 (as in JAX, whatever ``dtype``), experts stacked
    [E, ...] in ``dtype``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": dense_init(gen, (d, e), d, torch.float32),
        "gate": dense_init(gen, (e, d, f), d, dtype),
        "up": dense_init(gen, (e, d, f), d, dtype),
        "down": dense_init(gen, (e, f, d), f, dtype),
    }


def top_k(probs: torch.Tensor, k: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest along the last axis, ties
    to the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_counts(e_flat: torch.Tensor, e: int) -> torch.Tensor:
    """i64[e]: the pairs routed to each expert (``bincount`` with a shape
    fixed by ``e``, as a trace on shape-only tensors needs; an integer
    scatter-add, exact in any order)."""
    ones = torch.ones_like(e_flat, dtype=torch.int64)
    return torch.zeros(e, dtype=torch.int64,
                       device=e_flat.device).index_add_(0, e_flat, ones)


def _route(xf: torch.Tensor, router: torch.Tensor, k: int):
    """(probs [T,E], normalised top-k weights [T,k], experts [T,k]), in
    f32 for numerics."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    w, idx = top_k(probs, k)
    return probs, w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), idx


def _slots(e_key: torch.Tensor, n: int, cap: int,
           offset: torch.Tensor | None = None):
    """The stable sort of pairs by expert (``e_key``; ``n`` and above are
    no expert of this rank) and each pair's dispatch slot: its rank in
    its expert's run, kept below ``cap`` once the run's ``offset`` earlier
    pairs (on lower ranks) are counted; dropped pairs go to row n*cap.
    Returns (order, keep, slot)."""
    order = torch.argsort(e_key, stable=True)
    e_sorted = e_key[order]
    pos = segment_rank(e_sorted)
    queued = pos if offset is None else pos + offset[e_sorted]
    keep = (e_sorted < n) & (queued < cap)
    slot = torch.where(keep, e_sorted * cap + pos, n * cap).long()
    return order, keep, slot


def _experts(xf, order, slot, k: int, n: int, cap: int, gate, up, down):
    """Dispatch the kept pairs' tokens into [n, cap, D], run the batched
    expert SwiGLU, and return its output rows [n*cap + 1, D] (the last
    row zero, for the dropped pairs)."""
    d = xf.shape[1]
    # kept pairs write distinct rows; the dropped ones all land on the
    # overflow row, which no expert reads
    buf = torch.zeros((n * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf[slot] = xf[order // k]
    expert_in = buf[:n * cap].reshape(n, cap, d)
    g = torch.bmm(expert_in, gate)
    u = torch.bmm(expert_in, up)
    out = torch.bmm(swiglu(g, u), down).reshape(n * cap, d)
    return torch.cat([out, torch.zeros((1, d), dtype=out.dtype,
                                       device=out.device)])


def _combine(flat_out, order, keep, slot, w, t: int, k: int):
    """Each token's k weighted outputs, summed in ascending expert order
    (a gather, not a scatter-add)."""
    # sorted position of pair p (token p // k, choice p % k); the stable
    # sort puts a token's pairs in ascending expert order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    at = torch.sort(inv.reshape(t, k), dim=-1).values          # [T, k]
    contrib = flat_out[slot[at]] * torch.where(
        keep[at], w.reshape(-1)[order[at]].to(flat_out.dtype),
        0.0)[..., None]
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def _model_axis_leaves(params: dict, cfg: ModelConfig, constrain):
    """The non-EP path's leaves under ``param_pspecs`` on a model axis
    larger than 1 that does not divide the experts: each leaf's FSDP dims
    gathered (unless they come gathered, as inside a model's blocks), and
    the ``TensorParallel`` view when ``ffn`` is cut over the model axis
    (``gate``/``up`` this rank's columns, ``down`` its rows), else None:
    the leaves are whole and every model rank computes the whole
    layer."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    shapes = {"router": (d, e), "gate": (e, d, f), "up": (e, d, f),
              "down": (e, f, d)}
    specs = param_pspecs({k: types.SimpleNamespace(shape=v)
                          for k, v in shapes.items()},
                         constrain.mesh, constrain.rules)
    tp = TensorParallel(constrain.mesh, constrain.rules.model, specs)
    out = {}
    for name, w in params.items():
        mine = tuple(n // tp.size if tp.cut(name, dim) else n
                     for dim, n in enumerate(shapes[name]))
        out[name] = w if tuple(w.shape) == mine else \
            constrain.gather_fsdp(w, specs[name])
    return out, (tp if tp.cut("gate", 2) else None)


def moe_block(params: dict, cfg: ModelConfig, x: torch.Tensor,
              capacity: int | None = None, constrain=None, sp=None
              ) -> tuple[torch.Tensor, dict]:
    """x [B,S,D] -> ([B,S,D], {"load_balance_loss", "dropped_frac"}).

    ``constrain`` (a ``sharding.rules.Constrainer``) with a model axis
    larger than 1 that divides the experts runs ``moe_block_ep``; with
    batch axes, x is this rank's rows and routing is global (see the
    module's docstring).  On a model axis that does not divide the
    experts, with ``constrain.param_specs`` (the leaves are this rank's
    blocks), this is JAX's reference path under GSPMD: when ``ffn`` is
    cut, each model rank computes its columns of ``gate``/``up`` and its
    rows of ``down`` for the whole dispatch buffer, and one psum over the
    model axis sums the ranks' combined outputs; else every model rank
    computes the whole layer.  ``sp`` (a
    ``sharding.rules.SequenceParallel``): x is the rank's block of the
    sequence."""
    ep = constrain.ep_context() if constrain is not None else None
    if ep is not None and cfg.num_experts % ep[2] == 0:
        return moe_block_ep(params, cfg, x, constrain, sp)
    tp = None
    if ep is not None and constrain.param_specs is not None:
        params, tp = _model_axis_leaves(params, cfg, constrain)
    # every model rank routes the whole sequence alike
    x = enter(x, None, sp)
    b, s, d = x.shape
    t = b * s
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    mesh = constrain.mesh if constrain is not None else None
    dp = constrain.batch_axes if constrain is not None else ()
    n_dp = mesh.axis_size(dp) if dp else 1
    cap = capacity or moe_capacity(cfg, t * n_dp)
    xf = x.reshape(t, d)

    probs, w, idx = _route(xf, params["router"], k)
    e_flat = idx.reshape(-1).to(torch.int32)                   # [T*k]
    offset = None
    if dp:
        # pairs to each expert on the ranks before this one
        counts = _expert_counts(e_flat, e)
        every = mesh.all_gather(counts[None], dp, dim=0)       # [n_dp, E]
        offset = every[:mesh.axis_index(dp)].sum(0)
    order, keep, slot = _slots(e_flat, e, cap, offset)
    if tp is not None:
        # the model ranks' ffn blocks differ: their shares are summed
        xf, w = tp.fan_out(xf), tp.fan_out(w)
    flat_out = _experts(xf, order, slot, k, e, cap, params["gate"],
                        params["up"], params["down"])
    y = _combine(flat_out, order, keep, slot, w, t, k)

    # --- aux: load-balance loss terms (Switch aux loss) --------------------
    if dp:
        sums = mesh.psum(torch.cat([probs.sum(0), keep.float().sum()[None]]),
                         dp)
        me, kept = sums[:e] / (t * n_dp), sums[e]
        ce = every.sum(0).float() / (t * k * n_dp)
    else:
        me, kept = probs.mean(0), keep.float().sum()
        ce = _expert_counts(e_flat, e).float() / (t * k)
    aux = {"load_balance_loss": e * torch.sum(me * ce),
           "dropped_frac": 1.0 - kept / (t * k * n_dp)}
    return leave(y.reshape(b, s, d), tp, sp), aux


def _token_blocks(mesh, xf, rows, want):
    """This rank's block, row-major over ``want``, of the flat tokens of
    the global batch (JAX's ``P(want)`` on [T, D]), from its rows' flat
    tokens (the rows split over ``rows``): its contiguous block over the
    remaining axes when ``rows`` leads ``want``, else the block of the
    tokens all-gathered over ``rows``."""
    if want[:len(rows)] == rows:
        return mesh.split(xf, want[len(rows):], 0)
    return mesh.split(mesh.all_gather(xf, rows, 0), want, 0)


def _row_tokens(mesh, y, rows, want):
    """``_token_blocks``'s inverse: this rank's rows of the outputs whose
    block over ``want`` it holds."""
    if want[:len(rows)] == rows:
        return mesh.all_gather(y, want[len(rows):], 0)
    return mesh.split(mesh.all_gather(y, want, 0), rows, 0)


def moe_block_ep(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 constrain, sp=None) -> tuple[torch.Tensor, dict]:
    """Expert parallelism (JAX's ``shard_map`` EP): experts
    ``[shard*e_loc, (shard+1)*e_loc)`` live on model rank ``shard``,
    tokens on the batch axes (the same on every model rank).  Each rank
    routes its tokens, keeps the pairs to its experts with a capacity per
    (rank, local expert) of ``moe_capacity(cfg, t_loc)``, runs their
    SwiGLU, combines each token's share, and one ``psum`` over the model
    axis sums the shares.

    JAX splits the flat tokens [T, D] over every batch axis of the mesh
    when T divides their product (``t_loc`` = T / product), else every
    device routes all of them.  A rank holds its rows, split over the
    batch axes ``batch_pspec`` picks (``constrain.batch_axes``); where
    the two differ:
    - the tokens split over batch axes that carry no rows (one long
      request, or fewer rows than ranks): the rank takes its block of
      the flat tokens (``_token_blocks``; a contiguous block of its own
      rows' tokens when the rows' axes lead), routes it, and after the
      model-axis psum gathers the outputs back to its rows; whole
      leaves fan out over those axes, so their gradients sum there;
    - the rows split but the tokens not: every rank routes its rows as
      a part of the whole batch, with the whole batch's capacity and
      each pair's place in its expert's queue counting the pairs of the
      ranks before it (as ``moe_block``'s global routing).

    Leaves are this rank's blocks under ``param_pspecs``: the expert
    weights [e_loc, ...]; the router and the expert weights' FSDP dim
    (with ``expert_fsdp``) either whole or a block, which is gathered
    (``sharding.rules.gather_dim``).  Inside a model's blocks the FSDP
    dim comes gathered already (``transformer.apply_blocks``).  On a mesh
    of one rank this is ``moe_block`` exactly.

    ``sp`` (a ``sharding.rules.SequenceParallel`` over the model axis):
    x is the rank's block of the sequence, all-gathered at entry (every
    model rank routes the whole, as without ``sp``), and the output is
    reduce-scattered over the sequence in place of the psum (split after
    it when the tokens moved)."""
    mesh, rules = constrain.mesh, constrain.rules
    x = enter(x, None, sp)        # every model rank routes the whole alike
    model = (rules.model,)
    m = mesh.shape[rules.model]
    fsdp = rules.fsdp if rules.expert_fsdp else ()
    b, s, d = x.shape
    t = b * s
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    e_loc = e // m
    rows = constrain.batch_axes
    dp = tuple(a for a in rules.batch if mesh.shape.get(a, 1) > 1)
    t_all = t * (mesh.axis_size(rows) if rows else 1)
    want = dp if dp and t_all % mesh.axis_size(dp) == 0 else ()
    tok = want or rows            # the axes over which ranks' tokens differ
    moved = bool(want) and want != rows

    router, gate, up, down = (params[n] for n in ("router", "gate", "up",
                                                  "down"))
    if router.shape[1] != e:
        router = mesh.all_gather(router, model, dim=1)
    if gate.shape[0] != e_loc:
        raise ValueError(f"expert leaves hold {gate.shape[0]} experts, "
                         f"rank's block is {e_loc}")
    if fsdp and gate.shape[1] != d:
        gate, up = (gather_dim(w, fsdp, 1, mesh, rows) for w in (gate, up))
        down = gather_dim(down, fsdp, 2, mesh, rows)
    extra = tuple(a for a in tok if a not in rows)
    if extra:
        # the ranks of these axes hold the same rows but route other
        # tokens: the leaves' gradients are summed over them
        router, gate, up, down = (mesh.fan_out(w, extra)
                                  for w in (router, gate, up, down))

    xf = x.reshape(t, d)
    if moved:
        xf = _token_blocks(mesh, xf, rows, want)
    t_loc = xf.shape[0]
    cap = moe_capacity(cfg, t_loc if want else t_all)
    probs, w, idx = _route(xf, router, k)
    e0 = mesh.axis_index(model) * e_loc
    e_flat = idx.reshape(-1).to(torch.int32)
    local = (e_flat >= e0) & (e_flat < e0 + e_loc)
    e_local = torch.where(local, e_flat - e0, e_loc)           # park others
    offset = None
    if not want and rows:
        # the whole batch's queues: the pairs of the ranks before this one
        every = mesh.all_gather(_expert_counts(e_flat, e)[None], rows, 0)
        before = every[:mesh.axis_index(rows)].sum(0)[e0:e0 + e_loc]
        offset = torch.cat([before, before.new_zeros(1)])
    order, keep, slot = _slots(e_local, e_loc, cap, offset)
    # the tokens and weights are the same on every model rank; each rank's
    # experts see only their pairs
    flat_out = _experts(mesh.fan_out(xf, model), order, slot, k, e_loc,
                        cap, gate, up, down)
    y = _combine(flat_out, order, keep, slot, mesh.fan_out(w, model), t_loc,
                 k)
    # the ranks' experts' outputs differ: summed over the model ranks
    if moved:
        y = _row_tokens(mesh, mesh.psum(y, model), rows, want)
        y = leave(y.reshape(b, s, d), None, sp)
    else:
        y = leave(y.reshape(b, s, d), TensorParallel(mesh, rules.model, {}),
                  sp)

    # aux, as JAX reduces it: me and ce averaged over the batch axes before
    # their product; kept summed over the model axis
    n_pairs = t_loc * k
    if offset is not None:
        kept = mesh.psum(keep.float().sum(), model)
        sums = mesh.psum(torch.cat([probs.sum(0), kept[None]]), rows)
        me = sums[:e] / t_all
        ce = every.sum(0).float() / (t_all * k)
        dropped = 1.0 - sums[e] / (t_all * k)
        return y, {"load_balance_loss": e * torch.sum(me * ce),
                   "dropped_frac": dropped}
    me = probs.mean(0)
    ce = _expert_counts(e_flat, e).float() / n_pairs
    dropped = 1.0 - mesh.psum(keep.float().sum(), model) / n_pairs
    if want:
        both = mesh.psum(torch.cat([me, ce, dropped[None]]), want) \
            / mesh.axis_size(want)
        me, ce, dropped = both[:e], both[e:2 * e], both[2 * e]
    return y, {"load_balance_loss": e * torch.sum(me * ce),
               "dropped_frac": dropped}
