"""AdamW and its schedule, in plain PyTorch.

Port of ``repro.train.optimizer``.  Moments are f32 whatever the
parameter's dtype, and the update is computed in f32 and cast back (bf16
parameters, f32 master-style update).  The schedule and the bias
corrections are f32 tensor arithmetic, as JAX's are (``b1 ** step`` with
an f32 step, ``cos`` in f32): Python floats would compute them in f64.
Updates are functional: new tensors, the old state untouched.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "warmup_cosine", "global_norm", "clip_by_global_norm"]

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor        # i32[]
    m: dict                   # f32 tree like params
    v: dict                   # f32 tree like params


def adamw_init(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device)
    device = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def warmup_cosine(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), f32."""
    s = step.to(_F32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * prog))
    return cfg.peak_lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    """The f32 norm of every leaf of ``tree`` together.  With ``mesh``
    and ``specs`` (a tree of ``PartitionSpec`` like ``tree``) each leaf
    is this rank's block: its sum of squares is summed over the axes its
    spec cuts it over (of size > 1), and only those, one all-reduce a
    set of axes; the sums are then added in the leaves' order, so on a
    mesh of one rank the norm is bitwise the plain one."""
    sums = [torch.sum(torch.square(x.to(_F32))) for x in tree_leaves(tree)]
    if mesh is not None and specs is not None:
        from repro_torch.sharding.rules import spec_axes
        by_axes: dict = {}
        for i, s in enumerate(tree_leaves(specs)):
            axes = tuple(a for a in mesh.axis_names
                         if a in spec_axes(s, mesh))
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            part = mesh.psum(torch.stack([sums[i] for i in idx]), axes)
            for j, i in enumerate(idx):
                sums[i] = part[j]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(tree, max_norm: float, mesh=None, specs=None):
    """(tree scaled to a global norm of at most ``max_norm``, in f32;
    the norm before).  ``mesh``/``specs`` as in ``global_norm``."""
    norm = global_norm(tree, mesh, specs)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.to(_F32) * scale, tree), norm


def adamw_update(cfg: AdamWConfig, params, grads, state: OptState, *,
                 mesh=None, specs=None):
    """Returns (new_params, new_state, metrics ``{"lr", "grad_norm"}``).
    With ``mesh`` and ``specs`` (the parameters'), every leaf, moment and
    gradient is this rank's block, and the gradient norm is global."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, mesh, specs)
    step = state.step + 1
    lr = warmup_cosine(cfg, step)
    sf = step.to(_F32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=_F32, device=sf.device),
                          sf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=_F32, device=sf.device),
                          sf)

    def upd(p, g, m, v):
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m_new / b1c
        vh = v_new / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) \
            + cfg.weight_decay * p.to(_F32)
        return (p.to(_F32) - lr * delta).to(p.dtype), m_new, v_new

    _, flat_p, unflatten = tree_flatten(params)
    flat_g, flat_m, flat_v = (tree_leaves(t) for t in (grads, state.m,
                                                        state.v))
    out = [upd(p, g, m, v) for p, g, m, v in
           zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = unflatten([o[0] for o in out])
    new_m = unflatten([o[1] for o in out])
    new_v = unflatten([o[2] for o in out])
    return new_p, OptState(step, new_m, new_v), \
        {"lr": lr, "grad_norm": gnorm}
