"""The train step: loss -> gradients -> AdamW, with microbatch gradient
accumulation, the remat policy, and optional int8 error-feedback
compression of the gradients.

Port of ``repro.train.step``.  Gradients come from autograd, which on
CUDA tensors runs the attention and Mamba sub-layers' hand-written
backward kernels.  Microbatches accumulate their gradients into f32
buffers, as JAX's ``acc_body`` does.  JAX's ``constrain`` (sharding
constraints) and ``unroll`` (an XLA scan knob) have no one-card meaning
and are not taken.  A step is functional: it returns a new state and
leaves the one it was given untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train import compression
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_init,
                                         adamw_update)
from repro_torch.tree import tree_flatten, tree_map

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
                   remat: str = "nothing"):
    """(loss, metrics, grads) of ``M.loss_fn`` at ``params``: grads a tree
    like params, each leaf in its parameter's dtype (zeros where the loss
    does not reach it, as ``jax.grad`` gives)."""
    _, leaves, unflatten = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, metrics = M.loss_fn(unflatten(live), cfg, batch, remat=remat)
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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns step(state, batch) -> (state, metrics): ``loss``, ``lr``,
    ``grad_norm`` (f32 scalars), and ``xent``, ``moe_aux``,
    ``perplexity`` when ``tcfg.microbatches == 1``."""

    def step(state: TrainState, batch: dict):
        if tcfg.microbatches > 1:
            gsum, lsum = None, None
            for mb in _split_microbatches(batch, tcfg.microbatches):
                loss, _, g = loss_and_grads(state.params, cfg, mb,
                                            remat=tcfg.remat)
                if gsum is None:
                    gsum = tree_map(lambda p: torch.zeros(
                        p.shape, dtype=torch.float32, device=p.device),
                        state.params)
                    lsum = torch.zeros((), dtype=torch.float32,
                                       device=loss.device)
                gsum = tree_map(lambda a, b: a + b.to(torch.float32), gsum,
                                g)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / tcfg.microbatches, gsum)
            loss = lsum / tcfg.microbatches
            metrics = {}
        else:
            loss, metrics, grads = loss_and_grads(state.params, cfg, batch,
                                                  remat=tcfg.remat)

        ef = state.ef_error
        if tcfg.pod_compression and ef is not None:
            grads, ef = compression.ef_compress_tree(grads, ef)

        params, opt, opt_metrics = adamw_update(tcfg.opt, state.params,
                                                grads, state.opt)
        return TrainState(params=params, opt=opt, ef_error=ef), \
            {"loss": loss, **opt_metrics, **metrics}

    return step
