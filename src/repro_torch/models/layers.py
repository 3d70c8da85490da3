"""Shared neural layers: RMSNorm, RoPE, SwiGLU MLP, initializers.

Port of ``repro.models.layers``.  Parameters are plain dicts of tensors;
the dtype policy is the same: parameters in ``cfg.dtype``, reductions in
f32.  Weights keep JAX's ``[in, out]`` layout (``x @ w``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope", "apply_rope", "swiglu", "dense_init",
           "init_mlp", "mlp", "torch_dtype"]


def torch_dtype(name: str) -> torch.dtype:
    """``cfg.dtype`` ("bfloat16", "float32", ...) as a torch dtype."""
    return getattr(torch, name)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm with f32 statistics regardless of activation dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def rope(positions: torch.Tensor, head_dim: int, theta: float
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables for the given positions: [..., head_dim//2]."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """Rotate pairs (x1,x2) -> (x1 cos - x2 sin, x2 cos + x1 sin).

    x: [B, S, H, hd]; sin/cos: [B, S, hd//2] (broadcast over heads).
    """
    x1, x2 = x.float().chunk(2, dim=-1)
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def dense_init(gen: torch.Generator, shape, in_axis_size: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Scaled-normal init: std = 1/sqrt(fan_in), drawn in f32 on the
    generator's device."""
    std = 1.0 / math.sqrt(max(in_axis_size, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * std).to(dtype)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype) -> dict:
    return {
        "gate": dense_init(gen, (d_model, d_ff), d_model, dtype),
        "up": dense_init(gen, (d_model, d_ff), d_model, dtype),
        "down": dense_init(gen, (d_ff, d_model), d_ff, dtype),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU feed-forward: x [.., D] -> [.., D]."""
    g = x @ params["gate"]
    u = x @ params["up"]
    return swiglu(g, u) @ params["down"]
