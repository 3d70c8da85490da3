"""Mamba-1 selective SSM (falcon-mamba, and jamba's mamba sub-layers once
MoE is ported).

Port of ``repro.models.ssm``.  Where the JAX model runs a chunked
associative scan inline, the port's prefill/forward path calls
``kernels.selective_scan.selective_scan``: the CUDA kernel for CUDA
tensors (a sequential scan per channel, state in registers; in training
the backward kernel is its gradient), the plain sequential version,
differentiated by autograd, for CPU tensors.  The two sum in another
order than the JAX chunked scan; the tests hold them to 1e-4.

``cfg.ssm_scan_bf16`` is taken and changes nothing: in JAX it makes the
chunked scan's [B, Q, di, N] decay and cumprod tensors bf16, halving
their HBM traffic, but the port's scan kernel never writes those
tensors (its state stays in registers), so the scan runs in f32 either
way; the tests hold it to JAX's bf16 result within JAX's own distance
between its bf16 and f32 results.

Decode is the O(1) recurrent step with a rolling conv window + SSM state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init
from repro_torch.sharding.rules import enter, leave

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


def _ssm_inputs(params, cfg: ModelConfig, xc: torch.Tensor, tp=None):
    """Shared projections: xc [..., di] -> (dt [..., di], B/C [..., n]).
    With ``tp``, xc and ``x_proj``'s rows are this rank's channels: the
    product is psummed over the model ranks, then fans out to their
    different channels (``dt_proj``'s columns and the scan's)."""
    r, n = cfg.dt_rank_, cfg.ssm_state
    proj = xc @ params["x_proj"]
    if tp is not None:
        proj = tp.fan_out(tp.psum(proj))
    dt_raw, b_ssm, c_ssm = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus(dt_raw @ params["dt_proj"] + params["dt_bias"]).float()
    return dt, b_ssm.float(), c_ssm.float()


def _local_in_proj(w: torch.Tensor, tp, di: int) -> torch.Tensor:
    """This model rank's columns of ``in_proj`` [D, 2*di], its xc
    channels then its z channels.  ``param_pspecs`` cuts the [xc | z]
    columns into m contiguous blocks (at m = 2, rank 0 holds all of xc),
    so the leaf is gathered whole (its gradient reduce-scattered back)
    and the rank's two column runs taken."""
    w = tp.whole(w, "in_proj", differ=True)
    dl = di // tp.size
    lo = tp.index * dl
    return torch.cat([w[:, lo:lo + dl], w[:, di + lo:di + lo + dl]], dim=1)


def mamba_block(params, cfg: ModelConfig, x: torch.Tensor, tp=None,
                sp=None) -> torch.Tensor:
    """Prefill/forward Mamba sub-layer: [B,S,D] -> [B,S,D], the scan
    through the selective-scan kernel.

    ``tp`` (a ``sharding.rules.TensorParallel``): with ``inner`` cut
    over the model axis, each rank runs d_inner/m channels: its columns
    of ``in_proj`` (``_local_in_proj``) and ``dt_proj``, its rows of
    ``conv_w``, ``x_proj`` (then a psum) and ``out_proj`` (then a psum),
    its ``conv_b``, ``dt_bias``, ``A_log`` and ``D``; the input fans
    out.  Otherwise every leaf is whole and every model rank computes
    the whole sub-layer.

    ``sp`` (a ``sharding.rules.SequenceParallel``): x is the rank's
    block of the sequence; the whole sequence is gathered at entry (in
    place of the fan-out) and ``out_proj``'s product reduce-scattered
    over it (in place of the psum); computed whole, the rank keeps its
    block.  The scan runs over the whole sequence of the rank's
    channels: no state passes between ranks."""
    di = cfg.d_inner
    if tp is not None and not tp.cut("conv_w", 0):
        params = {n: tp.whole(w, n, differ=False) for n, w in params.items()}
        tp = None
    x = enter(x, tp, sp)
    if tp is None:
        xz = x @ params["in_proj"]
    else:
        xz = x @ _local_in_proj(params["in_proj"], tp, di)
        di //= tp.size
    xc, z = torch.split(xz, [di, di], dim=-1)
    xc = F.silu(_causal_conv(xc, params["conv_w"], params["conv_b"]))
    dt, b_ssm, c_ssm = _ssm_inputs(params, cfg, xc, tp)
    a = -torch.exp(params["A_log"])
    # B and C are column slices of one projection: the kernel takes them
    # contiguous
    y = selective_scan(dt, xc.float(), b_ssm.contiguous(),
                       c_ssm.contiguous(), a, params["D"])
    out = y.to(x.dtype) * F.silu(z)
    return leave(out @ params["out_proj"], tp, sp)


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
                       cache: dict, tp=None) -> tuple[torch.Tensor, dict]:
    """x [B,1,D], cache {conv [B,k-1,di], h [B,di,n]} -> (y [B,1,D], cache).

    The conv window and the state are updated in ``cache`` in place, where
    the JAX version returns new ones; the returned cache is the same dict.

    ``tp`` (a ``sharding.rules.TensorParallel``) with ``inner`` cut over
    the model axis: the rank runs its d_inner/m channels, as
    ``mamba_block`` does: ``in_proj`` gathered at use and cut to its
    ``xc``/``z`` columns (``_local_in_proj``), ``x_proj`` row-parallel
    with a psum, ``out_proj`` then a psum.  Its cache is its channels
    (``cache_pspecs`` cuts conv's and h's inner dim over the model
    axis), or, whole, the rank reads and updates its channels of it.
    Otherwise every leaf is whole and every model rank computes the
    whole step."""
    di = cfg.d_inner
    if tp is not None and not tp.cut("conv_w", 0):
        params = {n: tp.whole(w, n, differ=False) for n, w in params.items()}
        tp = None
    if cache["h"].shape[1] != di and tp is None:
        raise ValueError(f"a cache of {cache['h'].shape[1]} of {di} "
                         f"channels needs the Mamba leaves cut alike "
                         f"(param_specs)")
    mine = cache
    if tp is None:
        xz = x[:, 0] @ params["in_proj"]
    else:
        xz = x[:, 0] @ _local_in_proj(params["in_proj"], tp, di)
        dl = di // tp.size
        if cache["h"].shape[1] == di:
            lo = tp.index * dl
            mine = {"conv": cache["conv"][..., lo:lo + dl],
                    "h": cache["h"][:, lo:lo + dl]}
        di = dl
    xc, z = torch.split(xz, [di, di], dim=-1)

    win = torch.cat([mine["conv"], xc[:, None]], dim=1)        # [B,k,di]
    conv_out = torch.einsum("bkd,dk->bd", win, params["conv_w"]) \
        + params["conv_b"]
    xc = F.silu(conv_out)

    dt, b_ssm, c_ssm = _ssm_inputs(params, cfg, xc, tp)
    a = -torch.exp(params["A_log"])
    decay = torch.exp(dt[..., None] * a)                       # [B,di,n]
    h = decay * mine["h"] + (dt * xc.float())[..., None] \
        * b_ssm[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c_ssm) + xc.float() * params["D"]
    out = y.to(x.dtype) * F.silu(z)
    mine["conv"].copy_(win[:, 1:])
    mine["h"].copy_(h)
    out = (out @ params["out_proj"])[:, None]
    return leave(out, tp, None), cache
