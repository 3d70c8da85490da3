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
top-k weights still apply, as in GShard/Switch.  JAX's expert-parallel
``moe_block_ep`` needs a device mesh and has no counterpart on one card.
"""
from __future__ import annotations

import torch

from repro_torch.core.segments import segment_rank
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, swiglu

__all__ = ["init_moe", "moe_block", "moe_capacity", "top_k"]


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


def moe_block(params: dict, cfg: ModelConfig, x: torch.Tensor,
              capacity: int | None = None
              ) -> tuple[torch.Tensor, dict]:
    """x [B,S,D] -> ([B,S,D], {"load_balance_loss", "dropped_frac"})."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    cap = capacity or moe_capacity(cfg, t)
    xf = x.reshape(t, d)

    # --- routing (f32 for numerics) ---------------------------------------
    logits = xf.float() @ params["router"]                     # [T, E]
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k(probs, k)                                   # [T, k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)

    # --- sort-based dispatch ----------------------------------------------
    e_flat = idx.reshape(-1).to(torch.int32)                   # [T*k]
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    pos = segment_rank(e_sorted)
    keep = pos < cap
    slot = torch.where(keep, e_sorted * cap + pos, e * cap).long()
    token_of = order // k

    # kept pairs write distinct rows; the dropped ones all land on the
    # overflow row, which no expert reads
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = xf[token_of]
    expert_in = buf[:e * cap].reshape(e, cap, d)

    # --- batched expert SwiGLU --------------------------------------------
    g = torch.bmm(expert_in, params["gate"])
    u = torch.bmm(expert_in, params["up"])
    expert_out = torch.bmm(swiglu(g, u), params["down"])

    # --- combine: each token's k outputs, summed in expert order ----------
    flat_out = torch.cat([expert_out.reshape(e * cap, d),
                          torch.zeros((1, d), dtype=x.dtype,
                                      device=x.device)])
    # sorted position of pair p (token p // k, choice p % k); the stable
    # sort puts a token's pairs in ascending expert order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=x.device)
    at = torch.sort(inv.reshape(t, k), dim=-1).values          # [T, k]
    contrib = flat_out[slot[at]] * torch.where(
        keep[at], w.reshape(-1)[order[at]].to(x.dtype), 0.0)[..., None]
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]

    # --- aux: load-balance loss terms (Switch aux loss) --------------------
    me = probs.mean(0)                                         # [E]
    ce = torch.bincount(e_flat, minlength=e).float() / (t * k)
    aux = {
        "load_balance_loss": e * torch.sum(me * ce),
        "dropped_frac": 1.0 - keep.float().mean(),
    }
    return y.reshape(b, s, d), aux
