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


def _project(params, cfg: ModelConfig, x, name: str):
    """x @ w{name} (+ b{name}), as heads [B,S,-1,hd]."""
    y = x @ params[f"w{name}"]
    if cfg.qkv_bias:
        y = y + params[f"b{name}"]
    return y.reshape(*x.shape[:2], -1, cfg.head_dim)


def _project_qkv(params, cfg: ModelConfig, x, positions):
    """x [B,S,D] -> q [B,S,H,hd], k/v [B,S,K,hd] with bias/qknorm/rope."""
    q, kk, v = (_project(params, cfg, x, n) for n in "qkv")
    return _norm_rope(params, cfg, q, kk, v, positions)


def _norm_rope(params, cfg: ModelConfig, q, kk, v, positions):
    hd = cfg.head_dim
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


def _local_kv(params, cfg: ModelConfig, x, tp, hl: int):
    """This model rank's k and v for its ``hl`` query heads.  With the kv
    heads cut over the model axis and dividing it, its own; otherwise
    every kv head from the whole ``wk``/``wv`` (their gradients summed
    over the model ranks, each of which reads only some heads), then the
    ones its query heads read: a run of them when the query groups
    align with the rank's heads, else one a query head."""
    h, k = cfg.num_heads, cfg.num_kv_heads
    if k % tp.size == 0 and tp.cut("wk", 1):
        return _project(params, cfg, x, "k"), _project(params, cfg, x, "v")
    p = {n: tp.whole(params[n], n, differ=True) for n in
         (("wk", "wv", "bk", "bv") if cfg.qkv_bias else ("wk", "wv"))}
    kk, v = _project(p, cfg, x, "k"), _project(p, cfg, x, "v")
    g, first = h // k, tp.index * hl
    if hl % g == 0 or g % hl == 0:
        lo, hi = first // g, (first + hl - 1) // g + 1
        return kk[:, :, lo:hi], v[:, :, lo:hi].contiguous()
    idx = torch.arange(first, first + hl, device=x.device) // g
    return kk[:, :, idx], v[:, :, idx]


def attention_block(params, cfg: ModelConfig, x, positions, tp=None):
    """Prefill/forward attention sub-layer: [B,S,D] -> ([B,S,D], (k, v)),
    the attention itself through the flash-attention kernel.

    ``tp`` (a ``sharding.rules.TensorParallel``): with the query heads
    cut over the model axis and dividing it, each rank projects its
    H/m heads (``wq``/``bq`` its columns), its kv heads (see
    ``_local_kv``), runs the kernel on them, and ``wo`` (its rows) ends
    in a psum; the input and the whole ``q_norm``/``k_norm`` fan out
    over the model ranks.  Otherwise every leaf is taken whole and
    every model rank computes the whole sub-layer.  (k, v) are the
    rank's heads."""
    if tp is not None and not (tp.cut("wq", 1)
                               and cfg.num_heads % tp.size == 0):
        params = {n: tp.whole(w, n, differ=False) for n, w in params.items()}
        tp = None
    if tp is None:
        q, k, v = _project_qkv(params, cfg, x, positions)
    else:
        x = tp.fan_out(x)
        hl = cfg.num_heads // tp.size
        params = dict(params)
        for n in ("q_norm", "k_norm"):
            if n in params:
                params[n] = tp.fan_out(params[n])
        q = _project(params, cfg, x, "q")
        k, v = _local_kv(params, cfg, x, tp, hl)
        q, k, v = _norm_rope(params, cfg, q, k, v, positions)
    out = attention(q, k, v, causal=True, window=cfg.sliding_window)
    b, s, _, _ = out.shape
    y = out.reshape(b, s, -1) @ params["wo"]
    return (y if tp is None else tp.psum(y)), (k, v)


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
