"""GQA attention: the prefill/forward path through the flash-attention
kernel, and a cached decode path.  Supports QKV bias (qwen1.5/qwen2),
qk-norm (qwen3) and sliding windows (h2o-danube).

Port of ``repro.models.attention``.  Where the JAX model computes the
chunked online softmax inline (``flash_attention_ref``), the port calls
``kernels.flash_attention.attention``: the CUDA kernel for CUDA tensors
(with the backward kernel as its gradient in training), the plain version,
differentiated by autograd, for CPU tensors.  Decode attention stays
plain PyTorch (the JAX package has no kernel for it), as a partial
over a block of cache positions and a combine over blocks
(``decode_attention_partial``/``decode_attention_combine``): one block
on one rank, or the cache's sequence cut over ``rules.kv_seq``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, rms_norm, rope
from repro_torch.sharding.rules import enter, leave

__all__ = ["init_attention", "attention_block", "decode_attention",
           "decode_attention_partial", "decode_attention_combine",
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


def decode_attention_partial(q, k_cache, v_cache, cache_len, *,
                             offset: int = 0, window: int | None = None):
    """Single-token decode over a block of cache positions: q [B,1,H,hd]
    against k/v [B,Sb,K,hd], the cache's positions ``offset`` ..
    ``offset + Sb - 1``.  Returns, in f32, the row max ``m`` [B,K,G],
    the sum ``l`` [B,K,G] of ``exp(s - m)`` and the unnormalised output
    ``o`` [B,K,G,hd] (G = H/K).

    ``cache_len`` i32[B]: number of valid positions of the whole cache
    (a position is valid below it and, with ``window``, inside it)."""
    b, _, h, hd = q.shape
    _, sb, kh, _ = k_cache.shape
    g = h // kh
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(b, kh, g, hd)
    s = torch.einsum("bkgd,bckd->bkgc", qf, k_cache.float())
    pos = offset + torch.arange(sb, device=q.device)[None, :]
    mask = pos < cache_len[:, None]
    if window is not None:
        mask = mask & (pos >= cache_len[:, None] - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(-1)
    e = torch.exp(s - m[..., None])
    return m, e.sum(-1), torch.einsum("bkgc,bckd->bkgd", e, v_cache.float())


def decode_attention_combine(m, l, o, pmax=None, psum=None):
    """The attention output [B,K,G,hd] (f32) from blocks' partials:
    ``M = pmax(m)``, ``l' = psum(l e^(m-M))``, ``o' = psum(o e^(m-M))``,
    ``o'/l'``.  ``pmax``/``psum`` reduce over the blocks (over ranks, or
    a leading dim of stacked partials); without them the partials are
    one block's, and the output is ``o / l``.  A block whose positions
    are all masked has ``m`` = NEG_INF and weighs 0 beside any other."""
    if pmax is None:
        return o / l[..., None]
    w = torch.exp(m - pmax(m))
    lo = psum(torch.cat([(l * w)[..., None], o * w[..., None]], dim=-1))
    return lo[..., 1:] / lo[..., :1]


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: int | None = None, blocks: int = 1):
    """Single-token decode: q [B,1,H,hd] against cache [B,Smax,K,hd]:
    ``decode_attention_partial`` on each of ``blocks`` equal blocks of
    the cache's positions at its global offset, then their combine
    (over the stacked partials: on one device, the sums the ranks under
    ``kv_seq`` make over theirs).  One block: ``o / l``.

    ``cache_len`` i32[B]: number of valid positions.
    """
    b, _, h, hd = q.shape
    sb = k_cache.shape[1] // blocks
    parts = [decode_attention_partial(
        q, k_cache[:, i * sb:(i + 1) * sb], v_cache[:, i * sb:(i + 1) * sb],
        cache_len, offset=i * sb, window=window) for i in range(blocks)]
    if blocks == 1:
        out = decode_attention_combine(*parts[0])
    else:
        m, l, o = (torch.stack(t) for t in zip(*parts))
        out = decode_attention_combine(
            m, l, o, lambda t: t.amax(0, keepdim=True), lambda t: t.sum(0))
    return out.reshape(b, 1, h, hd).to(q.dtype)


def _heads_read(cfg: ModelConfig, tp, hl: int, device):
    """The kv heads this model rank's ``hl`` query heads read (of all
    K): a slice when the query groups align with its heads, else an
    index a query head."""
    h, k = cfg.num_heads, cfg.num_kv_heads
    g, first = h // k, tp.index * hl
    if hl % g == 0 or g % hl == 0:
        return slice(first // g, (first + hl - 1) // g + 1)
    return torch.arange(first, first + hl, device=device) // g


def _local_kv(params, cfg: ModelConfig, x, tp, hl: int):
    """This model rank's k and v for its ``hl`` query heads.  With the kv
    heads cut over the model axis and dividing it, its own; otherwise
    every kv head from the whole ``wk``/``wv`` (their gradients summed
    over the model ranks, each of which reads only some heads), then the
    ones its query heads read: a run of them when the query groups
    align with the rank's heads, else one a query head."""
    if _own_kv(cfg, tp):
        return _project(params, cfg, x, "k"), _project(params, cfg, x, "v")
    kk, v = _all_kv(params, cfg, x, tp, differ=True)
    heads = _heads_read(cfg, tp, hl, x.device)
    if isinstance(heads, slice):
        return kk[:, :, heads], v[:, :, heads].contiguous()
    return kk[:, :, heads], v[:, :, heads]


def _own_kv(cfg: ModelConfig, tp) -> bool:
    """Whether this model rank's kv heads are its own block: the kv
    heads cut over the model axis and dividing it."""
    return cfg.num_kv_heads % tp.size == 0 and tp.cut("wk", 1)


def _all_kv(params, cfg: ModelConfig, x, tp, *, differ: bool):
    """k and v of every kv head, from ``wk``/``wv`` (and biases) whole."""
    p = {n: tp.whole(params[n], n, differ=differ) for n in
         (("wk", "wv", "bk", "bv") if cfg.qkv_bias else ("wk", "wv"))}
    return _project(p, cfg, x, "k"), _project(p, cfg, x, "v")


def attention_block(params, cfg: ModelConfig, x, positions, tp=None,
                    sp=None):
    """Prefill/forward attention sub-layer: [B,S,D] -> ([B,S,D], (k, v)),
    the attention itself through the flash-attention kernel.

    ``tp`` (a ``sharding.rules.TensorParallel``): with the query heads
    cut over the model axis and dividing it, each rank projects its
    H/m heads (``wq``/``bq`` its columns), its kv heads (see
    ``_local_kv``), runs the kernel on them, and ``wo`` (its rows) ends
    in a psum; the input and the whole ``q_norm``/``k_norm`` fan out
    over the model ranks.  Otherwise every leaf is taken whole and
    every model rank computes the whole sub-layer.  (k, v) are the
    rank's heads.

    ``sp`` (a ``sharding.rules.SequenceParallel``): x is the rank's
    block of the sequence.  The whole sequence is gathered at entry (in
    place of the fan-out; ``positions`` are the whole sequence's) and
    ``wo``'s product reduce-scattered over it (in place of the psum);
    computed whole, the rank keeps its block.  (k, v) cover the whole
    sequence."""
    if tp is not None and not (tp.cut("wq", 1)
                               and cfg.num_heads % tp.size == 0):
        params = {n: tp.whole(w, n, differ=False) for n, w in params.items()}
        tp = None
    x = enter(x, tp, sp)
    if tp is None:
        q, k, v = _project_qkv(params, cfg, x, positions)
    else:
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
    return leave(out.reshape(b, s, -1) @ params["wo"], tp, sp), (k, v)


def _write(cache: dict, k_new, v_new, position, lo: int, smax: int):
    """The new key and value into ``cache``, this rank's block of
    positions ``lo`` .. ``lo + Sb - 1`` of a cache of ``smax``: at slot
    ``position % smax`` (a ring buffer for SWA caches, a plain write
    otherwise), by the rank whose block holds it."""
    sb = cache["k"].shape[1]
    slot = (position % smax).long()
    bidx = torch.arange(position.shape[0], device=position.device)
    if sb == smax:
        cache["k"][bidx, slot] = k_new[:, 0]
        cache["v"][bidx, slot] = v_new[:, 0]
        return
    local = slot - lo
    mine = ((local >= 0) & (local < sb))[:, None, None]
    local = local.clamp(0, sb - 1)
    for name, new in (("k", k_new), ("v", v_new)):
        c = cache[name]
        c[bidx, local] = torch.where(mine, new[:, 0], c[bidx, local])


def attention_decode_block(params, cfg: ModelConfig, x, cache, position,
                           tp=None, kv=None, attend=None):
    """Decode sub-layer: x [B,1,D], cache {k,v: [B,Smax,K,hd]},
    position i32[B] = current index.  Returns (out, cache).

    The new key and value are written into ``cache`` in place (a ring
    buffer for SWA caches, a plain write otherwise), where the JAX version
    returns an updated copy; the returned cache is the same dict.

    Across ranks the cache is this rank's block under ``cache_pspecs``:
    - ``tp`` (a ``sharding.rules.TensorParallel``) with the query heads
      cut and dividing the model axis: the rank projects its H/m query
      heads, and ``wo`` (its rows) ends in a psum; otherwise every leaf
      is whole and every model rank computes the whole sub-layer.
    - A cache holding K/m kv heads (cut over the model axis) holds the
      rank's own, from its columns of ``wk``/``wv``.  A cache holding
      all K (replicated over the model axis) is written whole, from
      ``wk``/``wv`` whole, and the rank reads the kv heads its query
      heads need.
    - ``kv`` (a ``sharding.rules.KVSeq``): the cache holds the rank's
      block of positions, every kv head.  Only the rank whose block
      holds slot ``position % Smax`` writes the new key and value; the
      mask reads global positions.  The rank's query heads are
      all-gathered over the model axis, the partial runs on its block,
      the combine reduces over ``kv.axes``, and the rank keeps its own
      heads' rows for ``wo``.

    ``attend`` (``decode_attention`` when None) attends over a cache
    whole in positions (no ``kv``)."""
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if tp is not None and not (tp.cut("wq", 1) and h % tp.size == 0):
        params = {n: tp.whole(w, n, differ=False) for n, w in params.items()}
        tp = None
    heads_cut = cache["k"].shape[2] != kh
    if heads_cut and tp is None:
        raise ValueError(
            f"a cache of {cache['k'].shape[2]} of {kh} kv heads needs the "
            f"attention leaves cut alike (param_specs)")
    pos = position[:, None]
    if tp is None:
        q, k_new, v_new = _project_qkv(params, cfg, x, pos)
    else:
        hl = h // tp.size
        q = _project(params, cfg, x, "q")
        if heads_cut:
            k_new = _project(params, cfg, x, "k")
            v_new = _project(params, cfg, x, "v")
        else:
            k_new, v_new = _all_kv(params, cfg, x, tp, differ=False)
        q, k_new, v_new = _norm_rope(params, cfg, q, k_new, v_new, pos)
    sb = cache["k"].shape[1]
    lo, smax = (0, sb) if kv is None else (kv.index * sb, kv.n * sb)
    _write(cache, k_new, v_new, position, lo, smax)
    cache_len = torch.clamp(position + 1, max=smax)
    b = x.shape[0]
    if kv is not None:
        if tp is not None:
            q = tp.mesh.all_gather(q, tp.axis, dim=2)
        out = decode_attention_combine(
            *decode_attention_partial(q, cache["k"], cache["v"], cache_len,
                                      offset=lo, window=cfg.sliding_window),
            kv.pmax, kv.psum).reshape(b, 1, h, hd).to(q.dtype)
        if tp is not None:
            out = out[:, :, tp.index * hl:(tp.index + 1) * hl]
    else:
        kc, vc = cache["k"], cache["v"]
        if tp is not None and not heads_cut:
            heads = _heads_read(cfg, tp, hl, x.device)
            kc, vc = kc[:, :, heads], vc[:, :, heads]
        out = (attend or decode_attention)(q, kc, vc, cache_len,
                                           window=cfg.sliding_window)
    y = out.reshape(b, 1, -1) @ params["wo"]
    return leave(y, tp, None), cache
