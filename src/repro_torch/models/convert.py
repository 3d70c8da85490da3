"""Parameters and decode caches between the JAX package's pytrees (as NumPy
arrays) and the port's nested dicts of tensors.

Both sides keep the same keys, the same ``[in, out]`` weight layout and
the same stacking over blocks, so a conversion is a copy leaf by leaf,
dtypes kept (``A_log``, ``D`` and an MoE ``router`` stay f32 in a bf16
model; expert weights are [num_blocks, E, ...]).  NumPy has no
bfloat16 of its own: JAX hands out ``ml_dtypes.bfloat16`` arrays, which
cross as their 16-bit patterns.

    np_params = jax.tree.map(np.asarray, params)
    tparams = params_from_jax(np_params, cfg, device="cpu")
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

__all__ = ["params_from_jax", "cache_from_jax", "to_numpy"]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree(v, device) for v in tree)
    return _tensor(tree, device)


def params_from_jax(np_params: dict, cfg: ModelConfig, device=None) -> dict:
    """The port's parameters from the JAX parameter pytree (NumPy leaves)."""
    expected = {f"sub{i}" for i in range(len(cfg.pattern))}
    if set(np_params["blocks"]) != expected:
        raise ValueError(f"{cfg.name}: blocks {sorted(np_params['blocks'])}"
                         f", expected {sorted(expected)}")
    return _tree(np_params, resolve_device(device))


def cache_from_jax(np_caches: dict, device=None) -> dict:
    """The port's decode caches from JAX ``init_cache`` / ``decode_step``
    caches (NumPy leaves)."""
    return _tree(np_caches, resolve_device(device))


def to_numpy(tree):
    """Nested dicts/tuples of tensors -> the same of NumPy arrays (bf16 as
    ``ml_dtypes.bfloat16``, the type JAX's arrays convert to)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
