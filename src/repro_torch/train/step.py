"""The train step: loss -> gradients -> AdamW, with microbatch gradient
accumulation, the remat policy, and optional int8 error-feedback
compression of the gradients.

Port of ``repro.train.step``.  Gradients come from autograd, which on
CUDA tensors runs the attention and Mamba sub-layers' hand-written
backward kernels.  Microbatches accumulate their gradients into f32
buffers, as JAX's ``acc_body`` does.  JAX's ``unroll`` (an XLA scan
knob) has no meaning here and is not taken.  A step is functional: it
returns a new state and leaves the one it was given untouched.

Data parallelism (``constrain`` from ``sharding.rules.make_constrain``
on a live mesh whose model axis is 1, as JAX's ``launch/train.py``
builds it): every rank holds the whole parameters, initialised alike,
and its rows of each microbatch (``data.synthetic.shard_batch``).  It
differentiates the global loss through its rows; the gradients are
summed over the batch axes in f32, in one all-reduce a step, before
error feedback, the gradient norm, clipping and AdamW, so every rank
makes the same update.

Sharded parameters (a ``constrain`` that carries ``param_pspecs`` of
the global parameters, as JAX's ``in_shardings``): the state's leaves,
AdamW's moments and the gradients are this rank's blocks.  FSDP's
gathers reduce-scatter their leaves' gradients over the batch axes in
the backward; the one f32 all-reduce then sums only the leaves that
still need it, over the batch axes their gathers did not reduce.
Tensor and expert parallelism need no sum over the model axis: the
modules' ``fan_out``s summed what differs there.  Under ``rules.sp``
neither does sequence parallelism: the leaves whole over the model axis
that a rank applies to its block of the sequence (``norm1``, ``norm2``,
``final_norm``) fan out over it in the forward
(``transformer._scale``, ``model.forward``), so each rank's gradient of
them is the whole sequence's.  The gradient norm adds each leaf's
blocks over the axes it is cut over.  Int8 error feedback
(``pod_compression``) rounds each sharded leaf as JAX rounds the global
leaf (``compression.ef_compress_tree(..., mesh=, specs=)``); its error
buffers are blocks under the parameters' specs, as ``init_train_state``
makes them from the parameters' blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import reduced_axes
from repro_torch.train import compression
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_init,
                                         adamw_update)
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

__all__ = ["TrainConfig", "TrainState", "init_train_state",
           "make_train_step", "loss_and_grads"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1          # gradient accumulation steps
    remat: str = "nothing"
    pod_compression: bool = False  # int8 EF wire format on grads


@dataclasses.dataclass
class TrainState:
    params: dict
    opt: OptState
    ef_error: Optional[dict] = None     # error-feedback buffers


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     generator: Optional[torch.Generator] = None, *,
                     device=None, params: Optional[dict] = None
                     ) -> TrainState:
    """A fresh state: ``params`` if given (e.g. JAX's, carried over by
    ``models.convert.params_from_jax``), else ``M.init_params`` drawn from
    ``generator`` on ``device``."""
    if params is None:
        params = M.init_params(cfg, generator, device=device)
    ef = None
    if tcfg.pod_compression:
        ef = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)
    return TrainState(params=params, opt=adamw_init(params), ef_error=ef)


def loss_and_grads(params, cfg: ModelConfig, batch: dict, *,
                   remat: str = "nothing", constrain=None):
    """(loss, metrics, grads) of ``M.loss_fn`` at ``params``: grads a tree
    like params, each leaf in its parameter's dtype (zeros where the loss
    does not reach it, as ``jax.grad`` gives).  With ``constrain``, this
    rank's share of the global loss's gradients."""
    _, leaves, unflatten = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, metrics = M.loss_fn(unflatten(live), cfg, batch, remat=remat,
                                  constrain=constrain)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(grads))


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        return x.reshape(n, b // n, *x.shape[1:])
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _sum_over_ranks(grads, constrain):
    """The gradients summed over the batch axes, each leaf over those its
    FSDP gather has not reduce-scattered it over: one f32 all-reduce for
    each set of axes (one in all under data parallelism), each leaf then
    cast back to its dtype."""
    _, leaves, unflatten = tree_flatten(grads)
    batch = constrain.batch_axes
    groups: dict = {}
    if constrain.param_specs is None:
        groups[batch] = list(range(len(leaves)))
    else:
        mesh, rules = constrain.mesh, constrain.rules
        for i, spec in enumerate(tree_leaves(constrain.param_specs)):
            done = reduced_axes(spec, mesh, rules, batch)
            axes = tuple(a for a in batch if a not in done)
            if axes:
                groups.setdefault(axes, []).append(i)
    out = list(leaves)
    for axes, idx in groups.items():
        flat = torch.cat([leaves[i].reshape(-1).to(torch.float32)
                          for i in idx])
        constrain.mesh.all_reduce_(flat, axes)
        at = 0
        for i in idx:
            g = leaves[i]
            out[i] = flat[at:at + g.numel()].view(g.shape).to(g.dtype)
            at += g.numel()
    return unflatten(out)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, constrain=None):
    """Returns step(state, batch) -> (state, metrics): ``loss``, ``lr``,
    ``grad_norm`` (f32 scalars), and ``xent``, ``moe_aux``,
    ``perplexity`` when ``tcfg.microbatches == 1``.  With ``constrain``,
    ``batch`` is this rank's rows and the metrics are global; with its
    ``param_specs``, the state's leaves are this rank's blocks."""
    across = constrain is not None and bool(constrain.batch_axes)
    mesh = specs = None
    if constrain is not None and constrain.param_specs is not None:
        mesh, specs = constrain.mesh, constrain.param_specs

    def step(state: TrainState, batch: dict):
        if tcfg.microbatches > 1:
            gsum, lsum = None, None
            for mb in _split_microbatches(batch, tcfg.microbatches):
                loss, _, g = loss_and_grads(state.params, cfg, mb,
                                            remat=tcfg.remat,
                                            constrain=constrain)
                if gsum is None:
                    gsum = tree_map(lambda p: torch.zeros(
                        p.shape, dtype=torch.float32, device=p.device),
                        state.params)
                    lsum = torch.zeros((), dtype=torch.float32,
                                       device=loss.device)
                gsum = tree_map(lambda a, b: a + b.to(torch.float32), gsum,
                                g)
                lsum = lsum + loss
            if across:
                gsum = _sum_over_ranks(gsum, constrain)
            grads = tree_map(lambda g: g / tcfg.microbatches, gsum)
            loss = lsum / tcfg.microbatches
            metrics = {}
        else:
            loss, metrics, grads = loss_and_grads(state.params, cfg, batch,
                                                  remat=tcfg.remat,
                                                  constrain=constrain)
            if across:
                grads = _sum_over_ranks(grads, constrain)

        ef = state.ef_error
        if tcfg.pod_compression and ef is not None:
            grads, ef = compression.ef_compress_tree(grads, ef, mesh=mesh,
                                                     specs=specs)

        params, opt, opt_metrics = adamw_update(tcfg.opt, state.params,
                                                grads, state.opt,
                                                mesh=mesh, specs=specs)
        return TrainState(params=params, opt=opt, ef_error=ef), \
            {"loss": loss, **opt_metrics, **metrics}

    return step
