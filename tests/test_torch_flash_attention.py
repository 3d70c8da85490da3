"""The port's flash attention on the CPU: its plain version against the JAX
``attention_ref`` and the Pallas kernel (interpret mode) on
``test_kernels.py``'s cases, and the CPU dispatch.  The CUDA kernel itself
is tested in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as j_ref
from repro.kernels.flash_attention import flash_attention as j_pallas
from repro_torch.kernels.flash_attention import (HEAD_DIMS, attention,
                                                 attention_ref, design,
                                                 flash_attention)

CASES = [
    (128, 128, 4, 4, 64, None),
    (256, 256, 8, 2, 64, None),        # GQA 4:1
    (128, 128, 4, 2, 128, 48),         # SWA
    (96, 96, 2, 2, 64, None),          # ragged vs 128 tiles
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # test_kernels.py's


def _inputs(seed, sq, skv, h, kh, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((2, sq, h, hd), (2, skv, kh, hd), (2, skv, kh, hd))]
    if dtype == "bfloat16":
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    tens = [torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
            for a in arrs]
    return [jnp.asarray(a) for a in arrs], tens


@pytest.mark.parametrize("sq,skv,h,kh,hd,window", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_ref_and_pallas(sq, skv, h, kh, hd,
                                                  window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(sq + h, sq, skv, h, kh, hd, dtype)
    got = attention_ref(q, k, v, causal=True, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    want_ref = j_ref(jq, jk, jv, causal=True, window=window)
    want_pal = j_pallas(jq, jk, jv, causal=True, window=window, bq=64,
                        bk=64, interpret=True)
    for want in (want_ref, want_pal):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("window", [None, 5])
def test_plain_version_non_causal_and_short_queries(window):
    """Sq < Skv, causal and not: the JAX reference's semantics (queries
    start at key 0)."""
    (jq, jk, jv), (q, k, v) = _inputs(3, 8, 20, 4, 2, 16, "float32")
    for causal in (True, False):
        got = attention_ref(q, k, v, causal=causal, window=window)
        want = j_ref(jq, jk, jv, causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)


def test_dispatch_takes_plain_version_on_cpu():
    _, (q, k, v) = _inputs(0, 32, 32, 4, 2, 16, "float32")
    before = flash_attention.launches
    got = attention(q, k, v, causal=True, window=7)
    assert torch.equal(got, attention_ref(q, k, v, causal=True, window=7))
    assert flash_attention.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    _, (q, k, v) = _inputs(0, 32, 32, 4, 2, 16, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma-bf16"),
                                        (torch.float32, "fma-f32")])
def test_design_routes_bf16_to_tensor_cores_and_f32_to_fma(dtype, want, hd):
    """bf16 runs on the tensor-core kernel at every head dim; f32 stays on
    the FMA kernel, whose f32 products keep the 2e-5 checks."""
    assert design(dtype, hd) == want


def test_design_refuses_other_dtypes():
    with pytest.raises(TypeError):
        design(torch.float16, 64)
