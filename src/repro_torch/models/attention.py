"""GQA attention: the prefill/forward path through the flash-attention
kernel, and a cached decode path.  Supports QKV bias (qwen1.5/qwen2),
qk-norm (qwen3) and sliding windows (h2o-danube).

Port of ``repro.models.attention``.  Where the JAX model computes the
chunked online softmax inline (``flash_attention_ref``), the port calls
``kernels.flash_attention.attention``: the CUDA kernel for CUDA tensors
(with the backward kernel as its gradient in training), the plain version,
differentiated by autograd, for CPU tensors.  Decode attention stays
plain PyTorch (the JAX package has no kernel for it).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, rms_norm, rope

__all__ = ["init_attention", "attention_block", "decode_attention",
           "attention_decode_block", "NEG_INF"]

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype) -> dict:
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d, h * hd), d, dtype),
        "wk": dense_init(gen, (d, k * hd), d, dtype),
        "wv": dense_init(gen, (d, k * hd), d, dtype),
        "wo": dense_init(gen, (h * hd, d), h * hd, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((k * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((k * hd,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(params, cfg: ModelConfig, x, positions):
    """x [B,S,D] -> q [B,S,H,hd], k/v [B,S,K,hd] with bias/qknorm/rope."""
    b, s, _ = x.shape
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    kk = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        kk = kk + params["bk"]
        v = v + params["bv"]
    q = q.reshape(b, s, h, hd)
    kk = kk.reshape(b, s, k, hd)
    v = v.reshape(b, s, k, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        kk = rms_norm(kk, params["k_norm"], cfg.norm_eps)
    sin, cos = rope(positions, hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    kk = apply_rope(kk, sin, cos)
    return q, kk, v


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: int | None = None):
    """Single-token decode: q [B,1,H,hd] against cache [B,Smax,K,hd].

    ``cache_len`` i32[B]: number of valid positions.
    """
    b, _, h, hd = q.shape
    _, smax, kh, _ = k_cache.shape
    g = h // kh
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(b, kh, g, hd)
    s = torch.einsum("bkgd,bckd->bkgc", qf, k_cache.float())
    pos = torch.arange(smax, device=q.device)[None, :]
    mask = pos < cache_len[:, None]
    if window is not None:
        mask = mask & (pos >= cache_len[:, None] - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def attention_block(params, cfg: ModelConfig, x, positions):
    """Prefill/forward attention sub-layer: [B,S,D] -> ([B,S,D], (k, v)),
    the attention itself through the flash-attention kernel."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = attention(q, k, v, causal=True, window=cfg.sliding_window)
    b, s, _, _ = out.shape
    return out.reshape(b, s, -1) @ params["wo"], (k, v)


def attention_decode_block(params, cfg: ModelConfig, x, cache, position):
    """Decode sub-layer: x [B,1,D], cache {k,v: [B,Smax,K,hd]},
    position i32[B] = current index.  Returns (out, cache).

    The new key and value are written into ``cache`` in place (a ring
    buffer for SWA caches, a plain write otherwise), where the JAX version
    returns an updated copy; the returned cache is the same dict.
    """
    q, k_new, v_new = _project_qkv(params, cfg, x, position[:, None])
    smax = cache["k"].shape[1]
    slot = (position % smax).long()
    bidx = torch.arange(x.shape[0], device=x.device)
    cache["k"][bidx, slot] = k_new[:, 0]
    cache["v"][bidx, slot] = v_new[:, 0]
    cache_len = torch.clamp(position + 1, max=smax)
    out = decode_attention(q, cache["k"], cache["v"], cache_len,
                           window=cfg.sliding_window)
    y = out.reshape(x.shape[0], 1, -1) @ params["wo"]
    return y, cache
