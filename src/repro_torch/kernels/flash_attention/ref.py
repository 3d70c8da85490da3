"""Plain PyTorch version of the flash-attention kernel: exact softmax
attention with causal/window masking and GQA grouping.

Port of ``repro.kernels.flash_attention.ref.attention_ref``.  It builds
the whole [B, Sq, KH, G, Skv] score tensor; the kernel never does.
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "NEG_INF"]

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True,
                  window: int | None = None) -> torch.Tensor:
    """q [B,Sq,H,hd], k/v [B,Skv,KH,hd] -> [B,Sq,H,hd] in q's dtype."""
    b, sq, h, hd = q.shape
    _, skv, kh, _ = k.shape
    g = h // kh
    qf = q.float().reshape(b, sq, kh, g, hd)
    s = torch.einsum("bqkgd,bckd->bqkgc", qf, k.float())
    s = s / math.sqrt(hd)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = (kpos <= qpos if causal
            else torch.ones((sq, skv), dtype=torch.bool, device=q.device))
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgc,bckd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)
