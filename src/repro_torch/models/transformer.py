"""Block assembly: the pattern's sub-layers, repeated ``num_blocks`` times.

Port of ``repro.models.transformer``.  Block parameters and caches are
stacked over blocks as in the JAX package ({'sub{i}': {...: [num_blocks,
...]}}), and a Python loop over blocks takes the place of ``lax.scan``:
block ``j`` reads views ``leaf[j]``, so nothing is copied.  Sub-layers
with MoE raise ``NotImplementedError`` (at init and in the converter)
until the MoE slice is ported.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import init_mlp, mlp, rms_norm, torch_dtype

__all__ = ["init_blocks", "apply_blocks", "apply_blocks_decode",
           "init_block_caches", "block_slice"]


def _has_mlp(cfg: ModelConfig, spec: LayerSpec) -> bool:
    return spec.moe or cfg.d_ff > 0


def _no_moe(spec: LayerSpec):
    if spec.moe:
        raise NotImplementedError(
            "MoE sub-layers are not ported yet (models/moe.py is a later "
            "slice of the port)")


def block_slice(tree, j: int):
    """The views ``leaf[j]`` of a nested dict of stacked tensors."""
    if isinstance(tree, dict):
        return {key: block_slice(val, j) for key, val in tree.items()}
    return tree[j]


def _stack(trees: list):
    """Stack a list of like nested dicts leaf by leaf, popping each leaf
    out of the dicts so its per-block tensors are freed once stacked."""
    first = trees[0]
    if isinstance(first, dict):
        return {key: _stack([t.pop(key) for t in trees])
                for key in list(first)}
    out = torch.stack(trees)
    trees.clear()
    return out


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_sublayer(gen: torch.Generator, cfg: ModelConfig,
                   spec: LayerSpec) -> dict:
    _no_moe(spec)
    dt = torch_dtype(cfg.dtype)
    p: dict[str, Any] = {"norm1": torch.zeros((cfg.d_model,), dtype=dt,
                                              device=gen.device)}
    if spec.mixer == "attn":
        p["mixer"] = attn.init_attention(gen, cfg, dt)
    else:
        p["mixer"] = ssm.init_mamba(gen, cfg, dt)
    if _has_mlp(cfg, spec):
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=dt, device=gen.device)
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dt)
    return p


def init_blocks(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """{'sub{i}': dict of tensors stacked over num_blocks}."""
    out = {}
    for i, spec in enumerate(cfg.pattern):
        per_block = [_init_sublayer(gen, cfg, spec)
                     for _ in range(cfg.num_blocks)]
        out[f"sub{i}"] = _stack(per_block)
    return out


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------
def _sublayer_fwd(params, cfg: ModelConfig, spec: LayerSpec, x, positions):
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    kv = None
    if spec.mixer == "attn":
        mix, kv = attn.attention_block(params["mixer"], cfg, h, positions)
    else:
        mix = ssm.mamba_block(params["mixer"], cfg, h)
    x = x + mix
    if _has_mlp(cfg, spec):
        h2 = rms_norm(x, params["norm2"], cfg.norm_eps)
        x = x + mlp(params["mlp"], h2)
    return x, kv


def apply_blocks(blocks: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, *, collect_kv: bool = False):
    """Run all layers.  Returns (x, kv) where kv is a tuple, one entry per
    attention sub-layer of the pattern, of (k, v) stacked over blocks
    [num_blocks, B, S, K, hd] (``()`` unless ``collect_kv``)."""
    kv_lists: list[list] = []
    for j in range(cfg.num_blocks):
        block = block_slice(blocks, j)
        kvs = []
        for i, spec in enumerate(cfg.pattern):
            x, kv = _sublayer_fwd(block[f"sub{i}"], cfg, spec, x, positions)
            if kv is not None and collect_kv:
                kvs.append(kv)
        kv_lists.append(kvs)
    if not collect_kv or not kv_lists or not kv_lists[0]:
        return x, ()
    stacked = tuple(
        (torch.stack([kvs[a][0] for kvs in kv_lists]),
         torch.stack([kvs[a][1] for kvs in kv_lists]))
        for a in range(len(kv_lists[0])))
    return x, stacked


# ---------------------------------------------------------------------------
# Decode (cached, one token)
# ---------------------------------------------------------------------------
def init_block_caches(cfg: ModelConfig, batch: int, max_seq: int,
                      device) -> dict:
    """Cache dict mirroring init_blocks (stacked per block).

    Attention sub-layers get [num_blocks, B, Smax, K, hd] ring/linear KV
    buffers (Smax = window for SWA archs); Mamba sub-layers get conv +
    state caches.  Position bookkeeping lives with the caller.
    """
    dt = torch_dtype(cfg.dtype)
    caches = {}
    for i, spec in enumerate(cfg.pattern):
        _no_moe(spec)
        if spec.mixer == "attn":
            smax = min(max_seq, cfg.sliding_window or max_seq)
            shape = (cfg.num_blocks, batch, smax, cfg.num_kv_heads,
                     cfg.head_dim)
            caches[f"sub{i}"] = {
                "k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
        else:
            one = ssm.init_mamba_cache(cfg, batch, dt, device)
            caches[f"sub{i}"] = {
                key: torch.zeros((cfg.num_blocks, *a.shape), dtype=a.dtype,
                                 device=device)
                for key, a in one.items()}
    return caches


def apply_blocks_decode(blocks: dict, caches: dict, cfg: ModelConfig,
                        x: torch.Tensor, position: torch.Tensor):
    """One decode step through all layers.

    x [B,1,D]; position i32[B] (absolute index of the new token).  The
    caches are updated in place; returns (x, caches).
    """
    for j in range(cfg.num_blocks):
        block, cache = block_slice(blocks, j), block_slice(caches, j)
        for i, spec in enumerate(cfg.pattern):
            p = block[f"sub{i}"]
            h = rms_norm(x, p["norm1"], cfg.norm_eps)
            if spec.mixer == "attn":
                mix, _ = attn.attention_decode_block(
                    p["mixer"], cfg, h, cache[f"sub{i}"], position)
            else:
                mix, _ = ssm.mamba_decode_block(p["mixer"], cfg, h,
                                                cache[f"sub{i}"])
            x = x + mix
            if _has_mlp(cfg, spec):
                h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
                x = x + mlp(p["mlp"], h2)
    return x, caches
