"""Mamba-1 selective SSM (falcon-mamba, and jamba's mamba sub-layers once
MoE is ported).

Port of ``repro.models.ssm``.  Where the JAX model runs a chunked
associative scan inline, the port's prefill/forward path calls
``kernels.selective_scan.selective_scan``: the CUDA kernel for CUDA
tensors (a sequential scan per channel, state in registers), the plain
sequential version for CPU tensors.  The two sum in another order than
the JAX chunked scan; the tests hold them to 1e-4.

``cfg.ssm_scan_bf16`` (bf16 decay/cumprod tensors in the JAX chunked scan)
has no counterpart: the port's scan always runs in f32.

Decode is the O(1) recurrent step with a rolling conv window + SSM state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init

__all__ = ["init_mamba", "mamba_block", "mamba_decode_block",
           "init_mamba_cache"]


def init_mamba(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    r, n, kw = cfg.dt_rank_, cfg.ssm_state, cfg.ssm_conv
    dev = gen.device
    # S4D-real initialization for A: A[d, n] = -(1..n)
    a = torch.arange(1, n + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(di, 1)
    dt_bias = torch.log(torch.expm1(torch.full((di,), 0.01,
                                               dtype=torch.float32,
                                               device=dev)))
    return {
        "in_proj": dense_init(gen, (d, 2 * di), d, dtype),
        "conv_w": dense_init(gen, (di, kw), kw, dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, (di, r + 2 * n), di, dtype),
        "dt_proj": dense_init(gen, (r, di), r, dtype),
        "dt_bias": dt_bias.to(dtype),
        "A_log": torch.log(a),                        # f32 [di, n]
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (di, d), di, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv: x [B,S,di], w [di,k] -- k shifted adds."""
    k = w.shape[1]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[:, 0]
    for j in range(1, k):
        out = out + xp[:, j:j + s] * w[:, j]
    return out + b


def _ssm_inputs(params, cfg: ModelConfig, xc: torch.Tensor):
    """Shared projections: xc [..., di] -> (dt [..., di], B/C [..., n])."""
    r, n = cfg.dt_rank_, cfg.ssm_state
    proj = xc @ params["x_proj"]
    dt_raw, b_ssm, c_ssm = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus(dt_raw @ params["dt_proj"] + params["dt_bias"]).float()
    return dt, b_ssm.float(), c_ssm.float()


def mamba_block(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Prefill/forward Mamba sub-layer: [B,S,D] -> [B,S,D], the scan
    through the selective-scan kernel."""
    di = cfg.d_inner
    xz = x @ params["in_proj"]
    xc, z = torch.split(xz, [di, di], dim=-1)
    xc = F.silu(_causal_conv(xc, params["conv_w"], params["conv_b"]))
    dt, b_ssm, c_ssm = _ssm_inputs(params, cfg, xc)
    a = -torch.exp(params["A_log"])
    # B and C are column slices of one projection: the kernel takes them
    # contiguous
    y = selective_scan(dt, xc.float(), b_ssm.contiguous(),
                       c_ssm.contiguous(), a, params["D"])
    out = y.to(x.dtype) * F.silu(z)
    return out @ params["out_proj"]


# ---------------------------------------------------------------------------
# Decode path (O(1) per token)
# ---------------------------------------------------------------------------
def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> dict:
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }


def mamba_decode_block(params, cfg: ModelConfig, x: torch.Tensor,
                       cache: dict) -> tuple[torch.Tensor, dict]:
    """x [B,1,D], cache {conv [B,k-1,di], h [B,di,n]} -> (y [B,1,D], cache).

    The conv window and the state are updated in ``cache`` in place, where
    the JAX version returns new ones; the returned cache is the same dict.
    """
    di = cfg.d_inner
    xz = x[:, 0] @ params["in_proj"]
    xc, z = torch.split(xz, [di, di], dim=-1)

    win = torch.cat([cache["conv"], xc[:, None]], dim=1)       # [B,k,di]
    conv_out = torch.einsum("bkd,dk->bd", win, params["conv_w"]) \
        + params["conv_b"]
    xc = F.silu(conv_out)

    dt, b_ssm, c_ssm = _ssm_inputs(params, cfg, xc)
    a = -torch.exp(params["A_log"])
    decay = torch.exp(dt[..., None] * a)                       # [B,di,n]
    h = decay * cache["h"] + (dt * xc.float())[..., None] \
        * b_ssm[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c_ssm) + xc.float() * params["D"]
    out = y.to(x.dtype) * F.silu(z)
    cache["conv"].copy_(win[:, 1:])
    cache["h"].copy_(h)
    return (out @ params["out_proj"])[:, None], cache
