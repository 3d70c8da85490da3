"""Plain PyTorch version of the selective-scan kernel: the sequential
Mamba-1 recurrence over time.

Port of ``repro.kernels.selective_scan.ref.selective_scan_ref``: one loop
step per token, holding the whole [B, di, N] state.
"""
from __future__ import annotations

import torch

__all__ = ["selective_scan_ref"]


def selective_scan_ref(dt, x, b_ssm, c_ssm, a, d_skip):
    """dt/x f32[B,S,di]; b/c f32[B,S,N]; a f32[di,N]; d f32[di] ->
    y f32[B,S,di]."""
    bsz, s, di = x.shape
    h = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(s):
        dt_t, x_t = dt[:, t], x[:, t]
        h = (torch.exp(dt_t[..., None] * a) * h
             + (dt_t * x_t)[..., None] * b_ssm[:, t, None, :])
        ys.append(torch.einsum("bdn,bn->bd", h, c_ssm[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(x)
    return y + x * d_skip
