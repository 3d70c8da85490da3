"""Top-level LM: embeddings (text / multi-codebook / VLM stub), the block
stack, head(s), the training loss, and the serving entry points
``prefill`` and ``decode_step``.

Port of ``repro.models.model``.  ``forward`` returns the MoE load-balance
loss as JAX's does; ``loss_fn`` is the training loss, differentiated by
autograd: on CUDA tensors the attention and Mamba sub-layers' gradients
come from the hand-written backward kernels (``kernels.flash_attention``,
``kernels.selective_scan``), on CPU tensors from their plain versions.
Parameters are a nested dict of tensors with the JAX package's keys and
layouts.  ``constrain`` (``sharding.rules.make_constrain`` on a live
mesh) makes a call one rank's part of a run across ranks: its tokens are
the rank's rows, MoE routes as JAX's program does over the whole batch,
and ``loss_fn`` returns the global loss.  When ``constrain`` also
carries the parameters' specs, each leaf is this rank's block (FSDP and
tensor parallelism at run time): the embedding is a lookup masked to
the rank's vocabulary rows and psummed over the model axis, the logits
stay cut over the vocabulary, and the cross-entropy takes its max and
its sum of exponentials over the model ranks and the gold logit from
the rank that holds it.  Under ``rules.sp`` the residual stream is the
rank's block of the sequence: the embedding ends in a reduce-scatter
over the sequence (or keeps the rank's block of a whole lookup), and
the final hidden sequence is gathered before the logits, which stay
cut over the vocabulary.  ``decode_step`` and ``init_cache`` take the
same ``constrain``; given ``cache_specs`` each cache is this rank's
block under ``cache_pspecs`` (see ``cache_specs``).  Entry points run
where the parameters live:
``init_params`` puts them on the CUDA device unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm, torch_dtype
from repro_torch.sharding.rules import cache_pspecs, leave

__all__ = ["init_params", "embed_tokens", "compute_logits", "forward",
           "loss_fn", "prefill", "decode_step", "init_cache", "cache_specs",
           "MOE_AUX_COEF"]

MOE_AUX_COEF = 0.01


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device=None, shard=None) -> dict:
    """Random parameters in ``cfg.dtype`` (``A_log`` and ``D`` in f32).

    Drawn from ``generator`` (a ``torch.Generator`` on ``device``; seed 0
    when None).  The numbers differ from JAX's ``init_params``; the tests
    go through ``models.convert.params_from_jax`` instead.  ``shard`` (a
    ``sharding.rules.LeafCutter``) keeps this rank's block of each leaf
    as it is drawn: the same global parameters at every world size,
    never whole on one device.
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
    cut = (lambda key, leaf: leaf) if shard is None else \
        (lambda key, leaf: shard((key,), leaf))
    params = {
        "embed": cut("embed", dense_init(generator, emb_shape, cfg.d_model,
                                         dt)),
        "blocks": tfm.init_blocks(generator, cfg, shard),
        "final_norm": cut("final_norm", torch.zeros((cfg.d_model,),
                                                    dtype=dt, device=dev)),
    }
    if not cfg.tie_embeddings:
        head_shape = (cfg.d_model, cfg.vocab_size) if cb == 1 else \
            (cb, cfg.d_model, cfg.vocab_size)
        params["head"] = cut("head", dense_init(generator, head_shape,
                                                cfg.d_model, dt))
    return params


def _vocab_tp(name: str, constrain):
    """(spec, ``TensorParallel`` view) of top-level leaf ``name`` (the
    embedding or the head): the view when its vocabulary is cut over
    the model axis, the only dim it may cut there (else None: the leaf
    is whole but for FSDP).  (None, None) without specs."""
    if constrain is None or constrain.param_specs is None:
        return None, None
    spec = constrain.param_specs[name]
    tp = constrain.tp({name: spec})
    vocab = len(spec) - (2 if name == "embed" else 1)
    return spec, (tp if tp is not None and tp.cut(name, vocab) else None)


def _top_leaf(params, name: str, constrain):
    """Top-level leaf ``name`` with its FSDP dims gathered, and its
    ``_vocab_tp`` view."""
    spec, tp = _vocab_tp(name, constrain)
    w = params[name]
    return (w if spec is None else constrain.gather_fsdp(w, spec)), tp


def _head_name(cfg: ModelConfig) -> str:
    return "embed" if cfg.tie_embeddings else "head"


def _seq_len(tokens, vision_embeds) -> int:
    """The length of the sequence ``embed_tokens`` makes."""
    return tokens.shape[1] + (0 if vision_embeds is None
                              else vision_embeds.shape[1])


def _seq(constrain, seq_len: int):
    """The ``SequenceParallel`` view of a forward over ``seq_len``
    positions, or None."""
    return None if constrain is None else constrain.seq(seq_len)


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor,
                 vision_embeds: Optional[torch.Tensor] = None,
                 constrain=None) -> torch.Tensor:
    """tokens [B,S] (or [B,S,CB] for codebooks) -> [B, S(+P), D].

    A lookup through ``F.embedding``, whose gradient is summed in a fixed
    order (indexing's ``index_put_`` accumulates on the CPU in no fixed
    order, so two training runs would part in the embedding's last bits).
    With the vocabulary cut over the model axis, each rank looks up the
    tokens of its rows (zero for the others) and the ranks' lookups are
    psummed (the vision tokens counted once, on model rank 0).  Under
    ``rules.sp`` (``constrain.seq`` of S(+P)) the result is this rank's
    block [B, (S+P)/m, D] of the sequence: the ranks' lookups are
    reduce-scattered over it in place of the psum, or a whole lookup
    keeps the rank's block (``sharding.rules.leave``).
    """
    sp = _seq(constrain, _seq_len(tokens, vision_embeds))
    table, tp = _top_leaf(params, "embed", constrain)
    lookup = F.embedding
    if tp is not None:
        vl = table.shape[-2]
        lo = tp.index * vl

        def lookup(t, w):
            t = t - lo
            ok = (t >= 0) & (t < vl)
            return torch.where(ok[..., None],
                               F.embedding(t.clamp(0, vl - 1), w), 0)
    if cfg.num_codebooks:
        # sum of per-codebook embeddings
        x = lookup(tokens[..., 0], table[0])
        for c in range(1, cfg.num_codebooks):
            x = x + lookup(tokens[..., c], table[c])
    else:
        x = lookup(tokens, table)
    if vision_embeds is not None:
        vision = vision_embeds.to(x.dtype)
        if tp is not None and tp.index:
            vision = torch.zeros_like(vision)      # summed once, below
        x = torch.cat([vision, x], dim=1)
    return leave(x, tp, sp)


def compute_logits(params, cfg: ModelConfig, hidden: torch.Tensor,
                   constrain=None) -> torch.Tensor:
    """hidden [B,S,D] -> logits [B,S,V] (or [B,S,CB,V]); with the
    vocabulary cut over the model axis, this rank's V/m of them."""
    w, tp = _top_leaf(params, _head_name(cfg), constrain)
    if tp is not None:
        hidden = tp.fan_out(hidden)
    if cfg.tie_embeddings:
        if cfg.num_codebooks:
            return torch.einsum("bsd,cvd->bscv", hidden, w)
        return hidden @ w.T
    if cfg.num_codebooks:
        return torch.einsum("bsd,cdv->bscv", hidden, w)
    return hidden @ w


def forward(params, cfg: ModelConfig, tokens, *, vision_embeds=None,
            remat: str = "none", collect_kv: bool = False,
            metrics: list | None = None, constrain=None):
    """Returns (hidden [B,Stot,D], kv stacks | (), moe_aux): ``moe_aux``
    is the f32 load-balance loss summed over the MoE sub-layers (0
    without MoE).  ``metrics``, if given, collects every MoE sub-layer's
    ``{"load_balance_loss", "dropped_frac"}`` in order.  ``remat`` as in
    ``transformer.apply_blocks``; it defaults to "none" here (JAX's
    ``forward`` defaults to "nothing"), so a call keeps its launches, and
    ``loss_fn`` defaults to "nothing" as JAX's does.  ``constrain`` goes
    to every MoE sub-layer.  Under ``rules.sp`` the blocks run on this
    rank's block of the sequence, and the final hidden sequence is
    gathered whole (its gradient the rank's block)."""
    s = _seq_len(tokens, vision_embeds)
    sp = _seq(constrain, s)
    x = embed_tokens(params, cfg, tokens, vision_embeds, constrain)
    positions = torch.arange(s, device=x.device)[None, :]
    x, kvs, aux, moe = tfm.apply_blocks(params["blocks"], cfg, x, positions,
                                        remat=remat, collect_kv=collect_kv,
                                        constrain=constrain)
    if metrics is not None:
        metrics.extend(moe)
    x = rms_norm(x, tfm._scale(params, "final_norm", sp), cfg.norm_eps)
    return (x if sp is None else sp.all_gather(x)), kvs, aux


def _xent(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
          constrain=None, tp=None):
    """Mean masked cross-entropy in f32; logits [..., V], targets [...].
    With ``constrain``'s batch axes, the mean over every rank's rows: the
    sums of nll and mask are summed over the ranks before the divide.
    With ``tp``, logits are this model rank's block of the vocabulary:
    the max and the sum of exponentials are taken over the model ranks,
    and the gold logit comes from the rank that holds it."""
    lf = logits.float()
    if tp is None:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    else:
        vl = lf.shape[-1]
        top = tp.mesh.pmax(lf.amax(-1), tp.axis)
        lse = torch.log(tp.psum(torch.exp(lf - top[..., None]).sum(-1))) \
            + top
        t = targets.long() - tp.index * vl
        ok = (t >= 0) & (t < vl)
        mine = torch.gather(lf, -1, t.clamp(0, vl - 1)[..., None])[..., 0]
        gold = tp.psum(torch.where(ok, mine, 0.0))
    nll = (lse - gold) * mask
    if constrain is None or not constrain.batch_axes:
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    sums = constrain.mesh.psum(torch.stack([nll.sum(), mask.sum()]),
                               constrain.batch_axes)
    return sums[0] / torch.clamp(sums[1], min=1.0)


def loss_fn(params, cfg: ModelConfig, batch: dict, *,
            remat: str = "nothing", constrain=None):
    """batch: tokens [B,S]/[B,S,CB], targets (same shape), optional
    vision_embeds [B,P,D], optional loss_mask.  Returns (loss, metrics):
    ``{"xent", "moe_aux", "perplexity"}``, f32 scalars.  With
    ``constrain``, the batch is this rank's rows and the loss is the
    global one, the same on every rank.

    JAX's ``unroll`` (an XLA scan knob) has no meaning here and is not
    taken."""
    tokens = batch["tokens"]
    vision = batch.get("vision_embeds")
    hidden, _, aux = forward(params, cfg, tokens, vision_embeds=vision,
                             remat=remat, constrain=constrain)
    if cfg.vision_tokens and vision is not None:
        hidden = hidden[:, vision.shape[1]:]
    logits = compute_logits(params, cfg, hidden, constrain)
    targets = batch["targets"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    xent = _xent(logits, targets, mask.float(), constrain,
                 _vocab_tp(_head_name(cfg), constrain)[1])
    loss = xent + MOE_AUX_COEF * aux
    return loss, {"xent": xent, "moe_aux": aux,
                  "perplexity": torch.exp(xent)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device=None, constrain=None) -> dict:
    """Zeroed decode caches for ``batch`` sequences of up to ``max_seq``
    (``transformer.init_block_caches``); with ``constrain`` carrying
    ``cache_specs``, this rank's block of each, never the whole."""
    return tfm.init_block_caches(cfg, batch, max_seq,
                                 resolve_device(device), constrain)


def cache_specs(cfg: ModelConfig, mesh, rules, batch: int,
                max_seq: int) -> dict:
    """``cache_pspecs`` of ``init_cache(cfg, batch, max_seq)``'s global
    caches (shapes only: nothing is allocated), for
    ``make_constrain(..., cache_specs=)``."""
    return cache_pspecs(cfg, mesh, rules, batch,
                        init_cache(cfg, batch, max_seq, device="meta"))


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, *, vision_embeds=None,
            metrics: list | None = None, constrain=None):
    """Full forward collecting KV; returns (last-token logits, kv stacks).

    kv stacks: tuple per attn sub-layer of (k, v) [num_blocks, B, S, K, hd]
    (this model rank's kv heads under tensor parallelism).  ``metrics``
    and ``constrain`` as in ``forward``; the logits are whole (gathered
    over the model axis when they are cut over the vocabulary).
    """
    hidden, kvs, _ = forward(params, cfg, tokens,
                             vision_embeds=vision_embeds, collect_kv=True,
                             metrics=metrics, constrain=constrain)
    logits = compute_logits(params, cfg, hidden[:, -1:], constrain)
    tp = _vocab_tp(_head_name(cfg), constrain)[1]
    if tp is not None:
        logits = tp.mesh.all_gather(logits, tp.axis, dim=logits.dim() - 1)
    return logits, kvs


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens_new, caches, position, *,
                constrain=None, attend=None):
    """One token for every sequence: tokens_new [B,1] (or [B,1,CB]),
    position i32[B].  Returns (logits [B,1,V...], caches), the caches
    updated in place.

    ``constrain`` (``sharding.rules.make_constrain`` on a live mesh):
    the tokens, positions and caches are this rank's rows, the leaves
    (given ``param_specs``) and caches (given ``cache_specs``) its
    blocks, as JAX's ``decode_step`` jitted with ``param_pspecs`` and
    ``cache_pspecs`` in-shardings runs them; the logits are whole
    (gathered over the model axis when the vocabulary is cut).

    ``attend``: the decode attention over a cache this rank holds whole
    in positions (``attention.decode_attention`` when None; with
    ``blocks=n`` it sums over n blocks of positions on one device, as
    the ranks under ``kv_seq`` sum over theirs)."""
    x = embed_tokens(params, cfg, tokens_new, constrain=constrain)
    x, caches = tfm.apply_blocks_decode(params["blocks"], caches, cfg, x,
                                        position, constrain, attend)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = compute_logits(params, cfg, x, constrain)
    tp = _vocab_tp(_head_name(cfg), constrain)[1]
    if tp is not None:
        logits = tp.mesh.all_gather(logits, tp.axis, dim=logits.dim() - 1)
    return logits, caches
