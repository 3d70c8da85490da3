"""Gradients through the port's two LM kernels on the CPU, where autograd
differentiates their plain versions: against ``jax.grad`` of the JAX
package's jnp paths, and the autograd route itself (the CPU call reaches
the plain version and launches nothing).  The backward kernels themselves
run only on the card (``test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: flash atol 1e-5 / rtol 1e-4 (f32, the same softmax summed in
another order); the scan atol 1e-4 / rtol 1e-3 (the port scans
sequentially, JAX by a chunked associative scan: the forward's 1e-4).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as j_kref
from repro.models.attention import flash_attention_ref as j_flash
from repro.models.ssm import selective_scan as j_scan
from repro_torch.kernels.flash_attention import (HEAD_DIMS, attention,
                                                 attention_ref, bwd_design,
                                                 flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.selective_scan import (selective_scan,
                                                selective_scan_bwd,
                                                selective_scan_ref)
from repro_torch.kernels.selective_scan import ops as scan_ops

FLASH_TOL = dict(atol=1e-5, rtol=1e-4)
SCAN_TOL = dict(atol=1e-4, rtol=1e-3)


def _flash_inputs(seed, b, sq, skv, h, kh, hd):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return r(b, sq, h, hd), r(b, skv, kh, hd), r(b, skv, kh, hd), \
        r(b, sq, h, hd)


def _port_grads(fn, arrays, dout):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_grads(fn, arrays, dout):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("sq,skv,h,kh,hd,window", [
    (64, 64, 4, 2, 16, None),       # GQA, causal
    (48, 48, 4, 4, 32, None),       # MHA
    (80, 80, 4, 2, 16, 9),          # sliding window
    (40, 72, 2, 1, 32, None),       # Sq < Skv
    (96, 96, 2, 2, 16, 33),         # MHA, window
])
@pytest.mark.parametrize("which", ["models.attention", "kernels.ref"])
def test_flash_gradients_match_jax(sq, skv, h, kh, hd, window, which):
    q, k, v, do = _flash_inputs(sq + hd, 2, sq, skv, h, kh, hd)
    out, got = _port_grads(
        lambda *t: attention(*t, causal=True, window=window), (q, k, v), do)
    if which == "kernels.ref":
        jfn = lambda *t: j_kref(*t, causal=True, window=window)  # noqa: E731
    else:       # several KV chunks of JAX's online softmax
        jfn = lambda *t: j_flash(*t, causal=True, window=window,  # noqa
                                 kv_chunk=32)
    jout, want = _jax_grads(jfn, (q, k, v), do)
    np.testing.assert_allclose(out, jout, **FLASH_TOL)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **FLASH_TOL)


def test_flash_non_causal_gradients_match_jax():
    q, k, v, do = _flash_inputs(5, 1, 32, 48, 4, 2, 16)
    _, got = _port_grads(lambda *t: attention(*t, causal=False), (q, k, v),
                         do)
    _, want = _jax_grads(lambda *t: j_kref(*t, causal=False), (q, k, v), do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **FLASH_TOL)


def _scan_inputs(seed, b, s, di, n):
    rng = np.random.default_rng(seed)
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    dt = np.log1p(np.exp(r(b, s, di))).astype(np.float32)
    a = -np.exp(r(di, n)).astype(np.float32)
    d = r(di)
    return [dt, r(b, s, di), r(b, s, n), r(b, s, n), a, d], r(b, s, di)


@pytest.mark.parametrize("s,di,n", [(32, 16, 4), (64, 24, 8), (48, 8, 16),
                                    (256, 12, 16)])
def test_scan_gradients_match_jax(s, di, n):
    args, dy = _scan_inputs(s * n, 2, s, di, n)
    out, got = _port_grads(selective_scan, args, dy)
    # JAX's argument order: (dt, B, C, xc, a, d)
    perm = [0, 2, 3, 1, 4, 5]
    jout, jg = _jax_grads(
        lambda dt, b, c, x, a, d: j_scan(dt, b, c, x, a, d,
                                         chunk=min(256, s)),
        [args[i] for i in perm], dy)
    want = [None] * 6
    for slot, g in zip(perm, jg):
        want[slot] = g
    np.testing.assert_allclose(out, jout, **SCAN_TOL)
    for name, g, w in zip(("dt", "x", "B", "C", "A", "D"), got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **SCAN_TOL)


def test_cpu_gradient_route_is_the_plain_version():
    """On CPU tensors ``attention``/``selective_scan`` are the plain
    versions, differentiated by autograd: the same graph, no launch."""
    q, k, v, do = _flash_inputs(0, 1, 32, 32, 4, 2, 16)
    counts = (flash_attention.launches, flash_attention_bwd.launches,
              selective_scan.launches, selective_scan_bwd.launches)
    _, got = _port_grads(lambda *t: attention(*t, window=5), (q, k, v), do)
    _, want = _port_grads(lambda *t: attention_ref(*t, window=5), (q, k, v),
                          do)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    args, dy = _scan_inputs(1, 1, 20, 8, 4)
    _, got = _port_grads(selective_scan, args, dy)
    _, want = _port_grads(selective_scan_ref, args, dy)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert counts == (flash_attention.launches, flash_attention_bwd.launches,
                      selective_scan.launches, selective_scan_bwd.launches)


def test_backward_wrappers_refuse_cpu_tensors():
    q, k, v, do = (torch.from_numpy(a) for a in
                   _flash_inputs(0, 1, 16, 16, 2, 1, 16))
    lse = torch.zeros((1, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, k, v, q, do, lse)
    args, dy = _scan_inputs(0, 1, 8, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_bwd(*(torch.from_numpy(a) for a in args),
                           torch.from_numpy(dy))


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma-bf16"),
                                        (torch.float32, "fma-tiles")])
def test_bwd_design_names_the_backward_kernel(dtype, want, hd):
    """bf16 runs the tensor-core backward at every head dim (16, 32 and 80
    padded), f32 the FMA tiles."""
    assert bwd_design(dtype, hd) == want


def test_bwd_design_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="head dim 24"):
        bwd_design(torch.bfloat16, 24)
    with pytest.raises(TypeError, match="float16"):
        bwd_design(torch.float16, 64)


def test_scan_exports_its_backward_design():
    scan_pkg = importlib.import_module("repro_torch.kernels.selective_scan")
    assert scan_pkg.BWD_DESIGN == scan_ops.BWD_DESIGN == "staged-recompute"
    assert "BWD_DESIGN" in scan_ops.__all__
    # the scratch of saved states follows the kernel's 32-step chunk
    assert (scan_ops._BWD_CHUNK, scan_ops._BWD_CHANNELS) == (32, 32)
    # the occupancy query refuses a state size with no instantiation
    # before it builds anything
    with pytest.raises(ValueError, match="state size 5"):
        scan_pkg.bwd_blocks_per_sm(5)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (False, 7)])
def test_cpu_flash_gradient_is_autograd_of_the_plain_version(causal,
                                                             window):
    """Not causal, causal and windowed: on CPU tensors ``attention`` is
    ``attention_ref`` under autograd, with no launch."""
    q, k, v, do = _flash_inputs(3, 1, 24, 40, 4, 1, 16)
    counts = (flash_attention.launches, flash_attention_bwd.launches)
    kw = dict(causal=causal, window=window)
    _, got = _port_grads(lambda *t: attention(*t, **kw), (q, k, v), do)
    _, want = _port_grads(lambda *t: attention_ref(*t, **kw), (q, k, v),
                          do)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert counts == (flash_attention.launches, flash_attention_bwd.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_refuses_cpu_tensors_of_either_dtype(dtype):
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in
                   _flash_inputs(1, 1, 16, 16, 2, 1, 32))
    lse = torch.zeros((1, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, k, v, q, do, lse)
