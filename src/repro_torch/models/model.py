"""Top-level LM: embeddings (text / multi-codebook / VLM stub), the block
stack, head(s), and the serving entry points ``prefill`` and
``decode_step``.

Port of ``repro.models.model`` without the training loss (a later slice);
``forward`` returns the MoE load-balance loss as JAX's does.
Parameters are a nested dict of tensors with the JAX package's keys and
layouts.  Entry points run where the parameters live: ``init_params``
puts them on the CUDA device unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm, torch_dtype

__all__ = ["init_params", "embed_tokens", "compute_logits", "forward",
           "prefill", "decode_step", "init_cache"]


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> dict:
    """Random parameters in ``cfg.dtype`` (``A_log`` and ``D`` in f32).

    Drawn from ``generator`` (a ``torch.Generator`` on ``device``; seed 0
    when None).  The numbers differ from JAX's ``init_params``; the tests
    go through ``models.convert.params_from_jax`` instead.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}")
    dt = torch_dtype(cfg.dtype)
    cb = max(cfg.num_codebooks, 1)
    emb_shape = (cfg.vocab_size, cfg.d_model) if cb == 1 else \
        (cb, cfg.vocab_size, cfg.d_model)
    params = {
        "embed": dense_init(generator, emb_shape, cfg.d_model, dt),
        "blocks": tfm.init_blocks(generator, cfg),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        head_shape = (cfg.d_model, cfg.vocab_size) if cb == 1 else \
            (cb, cfg.d_model, cfg.vocab_size)
        params["head"] = dense_init(generator, head_shape, cfg.d_model, dt)
    return params


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor,
                 vision_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """tokens [B,S] (or [B,S,CB] for codebooks) -> [B, S(+P), D]."""
    if cfg.num_codebooks:
        # sum of per-codebook embeddings
        x = params["embed"][0][tokens[..., 0]]
        for c in range(1, cfg.num_codebooks):
            x = x + params["embed"][c][tokens[..., c]]
    else:
        x = params["embed"][tokens]
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
    return x


def compute_logits(params, cfg: ModelConfig, hidden: torch.Tensor
                   ) -> torch.Tensor:
    """hidden [B,S,D] -> logits [B,S,V] (or [B,S,CB,V])."""
    if cfg.tie_embeddings:
        if cfg.num_codebooks:
            return torch.einsum("bsd,cvd->bscv", hidden, params["embed"])
        return hidden @ params["embed"].T
    if cfg.num_codebooks:
        return torch.einsum("bsd,cdv->bscv", hidden, params["head"])
    return hidden @ params["head"]


def forward(params, cfg: ModelConfig, tokens, *, vision_embeds=None,
            collect_kv: bool = False, metrics: list | None = None):
    """Returns (hidden [B,Stot,D], kv stacks | (), moe_aux): ``moe_aux``
    is the f32 load-balance loss summed over the MoE sub-layers (0
    without MoE).  ``metrics``, if given, collects every MoE sub-layer's
    ``{"load_balance_loss", "dropped_frac"}`` in order."""
    x = embed_tokens(params, cfg, tokens, vision_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, kvs, aux, moe = tfm.apply_blocks(params["blocks"], cfg, x, positions,
                                        collect_kv=collect_kv)
    if metrics is not None:
        metrics.extend(moe)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, kvs, aux


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device=None) -> dict:
    return tfm.init_block_caches(cfg, batch, max_seq,
                                 resolve_device(device))


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, *, vision_embeds=None,
            metrics: list | None = None):
    """Full forward collecting KV; returns (last-token logits, kv stacks).

    kv stacks: tuple per attn sub-layer of (k, v) [num_blocks, B, S, K, hd].
    ``metrics`` as in ``forward``.
    """
    hidden, kvs, _ = forward(params, cfg, tokens,
                             vision_embeds=vision_embeds, collect_kv=True,
                             metrics=metrics)
    return compute_logits(params, cfg, hidden[:, -1:]), kvs


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens_new, caches, position):
    """One token for every sequence: tokens_new [B,1] (or [B,1,CB]),
    position i32[B].  Returns (logits [B,1,V...], caches), the caches
    updated in place."""
    x = embed_tokens(params, cfg, tokens_new)
    x, caches = tfm.apply_blocks_decode(params["blocks"], caches, cfg, x,
                                        position)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return compute_logits(params, cfg, x), caches
