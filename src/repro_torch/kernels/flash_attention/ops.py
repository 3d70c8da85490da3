"""Dispatching wrapper for the flash-attention kernels: a hand-written CUDA
kernel for CUDA tensors, the plain PyTorch version for CPU tensors.

Two CUDA designs, named by ``design(dtype, hd)``: bf16 runs on the
tensor-core kernel (wgmma), f32 on the FMA kernel, whose f32 products keep
the 2e-5 checks that TF32 tensor cores would break.  The C entry point
picks between them by dtype, then the instantiation by head dim.

``flash_attention.launches`` counts the CUDA launches (reset by
assignment).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["attention", "attention_ref", "flash_attention", "design",
           "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 80, 128)       # the kernels' instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def design(dtype: torch.dtype, hd: int) -> str:
    """The kernel design that runs (dtype, hd) on the card: bf16 on the
    tensor cores at every head dim, f32 on the FMA kernel."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if dtype == torch.float32:
        return "fma-f32"
    if dtype == torch.bfloat16:
        return "wgmma-bf16"
    raise TypeError(f"flash_attention: dtype {dtype} not supported "
                    f"(float32, bfloat16)")


def attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """q [B,Sq,H,hd], k/v [B,Skv,KH,hd] -> [B,Sq,H,hd] (GQA: KH | H).

    CPU tensors take ``attention_ref``; CUDA tensors launch the kernel, or
    the call raises.
    """
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention(q, k, v, causal=causal, window=window)


def _library() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, i64, i64,
                       i64, i64, i64, ctypes.c_int, i64, p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronisation).

    q [B,Sq,H,hd], k/v [B,Skv,KH,hd], one dtype (f32 or bf16), contiguous,
    on one CUDA device; hd in ``HEAD_DIMS``; Sq <= Skv (queries start at
    key 0, as in the Pallas kernel); window None or >= 1.
    """
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"flash_attention needs CUDA tensors, got {device}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be [B, S, heads, hd]")
    b, sq, h, hd = q.shape
    _, skv, kh, _ = k.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} has dtype {t.dtype}, "
                            f"expected {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    if tuple(k.shape) != (b, skv, kh, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if kh == 0 or h % kh:
        raise ValueError(f"flash_attention: {h} query heads over {kh} KV "
                         f"heads")
    if sq > skv or skv == 0:
        raise ValueError(f"flash_attention: needs 0 < Skv and Sq <= Skv, got "
                         f"Sq={sq}, Skv={skv}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError("flash_attention: tensors above 2^31 elements")

    out = torch.empty_like(q)
    if sq == 0 or b == 0 or h == 0:
        return out
    if (design(q.dtype, hd) == "wgmma-bf16"
            and any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("flash_attention: the tensor-core kernel copies "
                         "16-byte chunks: q, k, v must be 16-byte aligned")
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, sq, skv, h, kh, hd,
            int(bool(causal)), window or 0, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
