"""Block assembly: the pattern's sub-layers, repeated ``num_blocks`` times.

Port of ``repro.models.transformer``.  Block parameters and caches are
stacked over blocks as in the JAX package ({'sub{i}': {...: [num_blocks,
...]}}), and a Python loop over blocks takes the place of ``lax.scan``:
block ``j`` reads views ``leaf[j]``, so nothing is copied.  A sub-layer
whose spec sets ``moe`` runs ``moe.moe_block`` as its MLP; the forward
pass sums its load-balance loss over sub-layers and blocks.

Remat: with a gradient wanted, each block runs under
``torch.utils.checkpoint`` (policy selectable, as JAX wraps each scan
step in ``jax.checkpoint``), so the backward recomputes the block's
internals, the attention and scan kernels' forward launches included.

Sharded parameters (a ``constrain`` that carries their specs): each
leaf is this rank's block.  A block's FSDP dims are gathered inside the
(checkpointed) block function, before its sub-layers run, and each
sub-layer computes on its tensor-parallel blocks (``sharding.rules.
TensorParallel``).  Under ``rules.sp`` the residual stream between
sub-layers is the rank's block of the sequence (``sharding.rules.
SequenceParallel``); the norms' scales then fan out over the model
axis, so each rank's gradient of them is the whole sequence's.  A
decode cache under ``cache_pspecs`` is this rank's block of it
(``init_block_caches(..., constrain=)``), and the decode sub-layers
take their tensor-parallel views and the cache's ``kv_seq`` view.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import init_mlp, mlp, rms_norm, torch_dtype
from repro_torch.sharding.rules import block_shape

__all__ = ["init_blocks", "apply_blocks", "apply_blocks_decode",
           "init_block_caches", "block_slice", "REMAT_POLICIES"]

_aten = torch.ops.aten
# what each policy saves (JAX's checkpoint_dots / ..._with_no_batch_dims):
# the outputs of matrix products, with or without a batch dimension
_DOTS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
         _aten.baddbmm.default}
_DOTS_NO_BATCH = {_aten.mm.default, _aten.addmm.default}
REMAT_POLICIES = {"none": None, "nothing": (), "dots": _DOTS,
                  "dots_no_batch": _DOTS_NO_BATCH}


def _save_ops(ops, ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in ops
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(fn, remat: str):
    """``fn`` under the named remat policy: "none" as it is, "nothing"
    recomputing everything, "dots"/"dots_no_batch" keeping the products'
    outputs (``create_selective_checkpoint_contexts``)."""
    ops = REMAT_POLICIES[remat]
    if ops is None:
        return fn
    kw = {}
    if ops:
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts,
            functools.partial(_save_ops, ops))
    return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False, **kw)


def _has_mlp(cfg: ModelConfig, spec: LayerSpec) -> bool:
    return spec.moe or cfg.d_ff > 0


def block_slice(tree, j: int):
    """The views ``leaf[j]`` of a nested dict of stacked tensors."""
    if isinstance(tree, dict):
        return {key: block_slice(val, j) for key, val in tree.items()}
    return tree[j]


def _alloc(tree, n: int):
    """Empty tensors [n, ...] shaped, typed and placed like ``tree``'s."""
    if isinstance(tree, dict):
        return {key: _alloc(val, n) for key, val in tree.items()}
    return torch.empty((n, *tree.shape), dtype=tree.dtype,
                       device=tree.device)


def _fill(out, tree, j: int):
    """``out[j] = tree``, leaf by leaf."""
    if isinstance(tree, dict):
        for key, val in tree.items():
            _fill(out[key], val, j)
    else:
        out[j].copy_(tree)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_sublayer(gen: torch.Generator, cfg: ModelConfig,
                   spec: LayerSpec) -> dict:
    dt = torch_dtype(cfg.dtype)
    p: dict[str, Any] = {"norm1": torch.zeros((cfg.d_model,), dtype=dt,
                                              device=gen.device)}
    if spec.mixer == "attn":
        p["mixer"] = attn.init_attention(gen, cfg, dt)
    else:
        p["mixer"] = ssm.init_mamba(gen, cfg, dt)
    if _has_mlp(cfg, spec):
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=dt, device=gen.device)
        if spec.moe:
            p["mlp"] = moe_mod.init_moe(gen, cfg, dt)
        else:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dt)
    return p


def _cut(shard, keys: tuple, tree, lead: int):
    """``shard(keys + path, leaf, lead)`` over a nested dict of leaves."""
    if isinstance(tree, dict):
        return {k: _cut(shard, keys + (k,), v, lead) for k, v in tree.items()}
    return shard(keys, tree, lead)


def init_blocks(gen: torch.Generator, cfg: ModelConfig, shard=None) -> dict:
    """{'sub{i}': dict of tensors stacked over num_blocks}.

    Each stacked leaf is allocated once and filled block by block, so
    the peak is the parameters plus one block's sub-layer (a full-size
    MoE model holds no second copy of its experts).  ``shard`` (a
    ``sharding.rules.LeafCutter``) keeps this rank's block of each drawn
    leaf; the draws are the same."""
    out = {}
    for i, spec in enumerate(cfg.pattern):
        stacked = None
        for j in range(cfg.num_blocks):
            block = _init_sublayer(gen, cfg, spec)
            if shard is not None:
                block = _cut(shard, ("blocks", f"sub{i}"), block,
                             cfg.num_blocks)
            if stacked is None:
                stacked = _alloc(block, cfg.num_blocks)
            _fill(stacked, block, j)
            del block
        out[f"sub{i}"] = stacked
    return out


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------
def _views(constrain, specs):
    """``part -> TensorParallel`` view of a sub-layer's part (None
    without specs)."""
    if specs is None:
        return lambda part: None
    return lambda part: constrain.tp(specs[part])


def _scale(params, name: str, sp):
    """Norm scale ``name``, fanned out over the model axis when it is
    applied to the rank's block of the sequence: in f32 (``rms_norm``
    reads it in f32 either way), so the ranks' partial gradients are
    summed before the one rounding to the leaf's dtype, as one rank's
    whole-sequence sum is."""
    w = params[name]
    return w if sp is None else sp.fan_out(w.float())


def _sublayer_fwd(params, cfg: ModelConfig, spec: LayerSpec, x, positions,
                  constrain=None, specs=None, sp=None):
    """One sub-layer; an MoE sub-layer returns its aux dict
    (``{"load_balance_loss", "dropped_frac"}``) as the third value
    (``None`` otherwise).  ``specs``: the sub-layer's leaves' specs when
    they are this rank's blocks (their FSDP dims gathered).  ``sp``: x
    is the rank's block of the sequence."""
    tp = _views(constrain, specs)
    h = rms_norm(x, _scale(params, "norm1", sp), cfg.norm_eps)
    kv, aux = None, None
    if spec.mixer == "attn":
        mix, kv = attn.attention_block(params["mixer"], cfg, h, positions,
                                       tp=tp("mixer"), sp=sp)
    else:
        mix = ssm.mamba_block(params["mixer"], cfg, h, tp=tp("mixer"),
                              sp=sp)
    x = x + mix
    if _has_mlp(cfg, spec):
        h2 = rms_norm(x, _scale(params, "norm2", sp), cfg.norm_eps)
        if spec.moe:
            y, aux = moe_mod.moe_block(params["mlp"], cfg, h2,
                                       constrain=constrain, sp=sp)
        else:
            y = mlp(params["mlp"], h2, tp=tp("mlp"), sp=sp)
        x = x + y
    return x, kv, aux


def apply_blocks(blocks: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, *, remat: str = "nothing",
                 collect_kv: bool = False, constrain=None):
    """Run all layers.  Returns (x, kv, aux, moe): kv is a tuple, one entry
    per attention sub-layer of the pattern, of (k, v) stacked over blocks
    [num_blocks, B, S, K, hd] (``()`` unless ``collect_kv``); aux the
    f32 load-balance loss summed over the MoE sub-layers (per block, then
    over blocks, as JAX's scan sums it; 0 without MoE); moe every MoE
    sub-layer's aux dict, in order.  ``constrain`` goes to every
    ``moe.moe_block`` (the ranks' mesh; see ``sharding.rules``).

    ``remat`` ("none", "nothing", "dots", "dots_no_batch", JAX's names)
    checkpoints each block when a gradient is wanted; under ``no_grad``
    (prefill) nothing is checkpointed.

    When ``constrain`` carries the parameters' specs, ``blocks`` holds
    this rank's blocks: each block's FSDP-cut leaves are gathered inside
    the block function, so a checkpointed block gathers them again in
    the backward and no rank holds more than one gathered block at a
    time.  With remat "none" autograd keeps each gathered block for the
    backward, as it keeps every activation.

    Under ``rules.sp`` (``constrain.seq`` of the positions' length), x
    is the rank's block [B, S/m, D] of the sequence, in and out, and
    ``positions`` the whole sequence's; kv covers the whole sequence."""
    specs = constrain.block_specs if constrain is not None else None
    sp = constrain.seq(positions.shape[-1]) if constrain is not None \
        else None

    def block_fn(x, block):
        if specs is not None:
            block = constrain.gather_block(block, specs)
        kvs, moe_j = [], []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, spec in enumerate(cfg.pattern):
            x, kv, m = _sublayer_fwd(block[f"sub{i}"], cfg, spec, x,
                                     positions, constrain,
                                     specs and specs[f"sub{i}"], sp)
            if kv is not None and collect_kv:
                kvs.append(kv)
            if m is not None:
                aux = aux + m["load_balance_loss"]
                moe_j.append(m)
        return x, kvs, aux, moe_j

    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat {remat!r} not in {sorted(REMAT_POLICIES)}")
    if torch.is_grad_enabled():
        block_fn = _checkpointed(block_fn, remat)
    kv_lists: list[list] = []
    block_aux, moe = [], []
    for j in range(cfg.num_blocks):
        x, kvs, aux, moe_j = block_fn(x, block_slice(blocks, j))
        moe.extend(moe_j)
        kv_lists.append(kvs)
        block_aux.append(aux)
    aux = torch.stack(block_aux).sum()
    if not collect_kv or not kv_lists or not kv_lists[0]:
        return x, (), aux, tuple(moe)
    stacked = tuple(
        (torch.stack([kvs[a][0] for kvs in kv_lists]),
         torch.stack([kvs[a][1] for kvs in kv_lists]))
        for a in range(len(kv_lists[0])))
    return x, stacked, aux, tuple(moe)


# ---------------------------------------------------------------------------
# Decode (cached, one token)
# ---------------------------------------------------------------------------
def init_block_caches(cfg: ModelConfig, batch: int, max_seq: int,
                      device, constrain=None) -> dict:
    """Cache dict mirroring init_blocks (stacked per block).

    Attention sub-layers get [num_blocks, B, Smax, K, hd] ring/linear KV
    buffers (Smax = window for SWA archs); Mamba sub-layers get conv +
    state caches.  Position bookkeeping lives with the caller.

    ``constrain`` carrying ``cache_specs`` (``cache_pspecs`` of these
    global caches): each leaf is allocated as this rank's block under
    its spec, never whole.
    """
    dt = torch_dtype(cfg.dtype)
    specs = None if constrain is None else constrain.cache_specs

    def zeros(i: int, key: str, shape, dtype):
        if specs is not None:
            shape = block_shape(shape, specs[f"sub{i}"][key], constrain.mesh)
        return torch.zeros(shape, dtype=dtype, device=device)

    caches = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.mixer == "attn":
            smax = min(max_seq, cfg.sliding_window or max_seq)
            shape = (cfg.num_blocks, batch, smax, cfg.num_kv_heads,
                     cfg.head_dim)
            caches[f"sub{i}"] = {key: zeros(i, key, shape, dt)
                                 for key in ("k", "v")}
        else:
            one = ssm.init_mamba_cache(cfg, batch, dt, "meta")
            caches[f"sub{i}"] = {
                key: zeros(i, key, (cfg.num_blocks, *a.shape), a.dtype)
                for key, a in one.items()}
    return caches


def apply_blocks_decode(blocks: dict, caches: dict, cfg: ModelConfig,
                        x: torch.Tensor, position: torch.Tensor,
                        constrain=None, attend=None):
    """One decode step through all layers.

    x [B,1,D]; position i32[B] (absolute index of the new token).  The
    caches are updated in place; returns (x, caches).  An MoE sub-layer
    routes the B tokens with the default capacity, as JAX's does.

    ``constrain`` (``sharding.rules.make_constrain`` on a live mesh):
    x is this rank's rows, each block's FSDP dims are gathered at use
    (as ``apply_blocks`` does, given ``param_specs``), each sub-layer
    takes its ``TensorParallel`` view, and an attention sub-layer its
    cache's ``kv_seq`` view (given ``cache_specs``); MoE sub-layers go
    through ``moe.moe_block`` with ``constrain`` (expert parallelism
    when the model axis divides the experts).  ``attend``: see
    ``attention.attention_decode_block``.
    """
    specs = constrain.block_specs if constrain is not None else None
    cspecs = constrain.cache_block_specs if constrain is not None else None
    for j in range(cfg.num_blocks):
        block, cache = block_slice(blocks, j), block_slice(caches, j)
        if specs is not None:
            block = constrain.gather_block(block, specs)
        for i, spec in enumerate(cfg.pattern):
            p = block[f"sub{i}"]
            tp = _views(constrain, specs and specs[f"sub{i}"])
            h = rms_norm(x, p["norm1"], cfg.norm_eps)
            if spec.mixer == "attn":
                kv = None if cspecs is None else \
                    constrain.kv_seq(cspecs[f"sub{i}"]["k"])
                mix, _ = attn.attention_decode_block(
                    p["mixer"], cfg, h, cache[f"sub{i}"], position,
                    tp=tp("mixer"), kv=kv, attend=attend)
            else:
                mix, _ = ssm.mamba_decode_block(p["mixer"], cfg, h,
                                                cache[f"sub{i}"],
                                                tp=tp("mixer"))
            x = x + mix
            if _has_mlp(cfg, spec):
                h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
                if spec.moe:
                    y, _ = moe_mod.moe_block(p["mlp"], cfg, h2,
                                             constrain=constrain)
                else:
                    y = mlp(p["mlp"], h2, tp=tp("mlp"))
                x = x + y
    return x, caches
