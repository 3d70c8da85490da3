"""Dispatching wrapper for the flash-attention kernels: hand-written CUDA
kernels for CUDA tensors, the plain PyTorch version for CPU tensors.

Two CUDA forward designs, named by ``design(dtype, hd)``: bf16 runs on
the tensor-core kernel (wgmma), f32 on the FMA kernel, whose f32
products keep the 2e-5 checks that TF32 tensor cores would break.  The C
entry point picks between them by dtype, then the instantiation by head
dim.

Gradients: ``attention`` on CUDA tensors that need one is a
``torch.autograd.Function``: its forward is the forward kernel, which
then also writes each row's log-sum-exp, and its backward is the
hand-written ``flash_attention_bwd`` kernel (``csrc/flash_attention_bwd.cu``;
no plain version or library attention runs).  Its two designs are named
by ``bwd_design(dtype, hd)``: bf16 on the tensor cores (wgmma), f32 on
FMA tiles.  On CPU tensors the
gradient is autograd through ``attention_ref``.  Without a gradient
(``no_grad``, serving) the call is the forward launch alone, as before.

``flash_attention.launches`` and ``flash_attention_bwd.launches`` count
the CUDA launches (reset by assignment).  Each kernel launches as the
operator ``repro_torch::flash_attention`` (``_bwd``), with its flop
formula (``kernels.work``); shape-only tensors (``work.shape_only``, the
dry-run's) take the CUDA route, where the operator launches nothing.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["attention", "attention_ref", "flash_attention",
           "flash_attention_bwd", "design", "bwd_design", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 80, 128)       # the kernels' instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pick(what, dtype, hd, f32, bf16):
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd} not in {HEAD_DIMS}")
    if dtype == torch.float32:
        return f32
    if dtype == torch.bfloat16:
        return bf16
    raise TypeError(f"{what}: dtype {dtype} not supported "
                    f"(float32, bfloat16)")


def design(dtype: torch.dtype, hd: int) -> str:
    """The kernel design that runs (dtype, hd) on the card: bf16 on the
    tensor cores at every head dim, f32 on the FMA kernel."""
    return _pick("flash_attention", dtype, hd, "fma-f32", "wgmma-bf16")


def bwd_design(dtype: torch.dtype, hd: int) -> str:
    """The backward kernel's design for (dtype, hd) on the card: bf16 on
    the tensor cores (wgmma) at every head dim, f32 on FMA tiles."""
    return _pick("flash_attention_bwd", dtype, hd, "fma-tiles", "wgmma-bf16")


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp, and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """q [B,Sq,H,hd], k/v [B,Skv,KH,hd] -> [B,Sq,H,hd] (GQA: KH | H).

    CPU tensors take ``attention_ref`` (autograd differentiates it); CUDA
    tensors launch the kernel, with the backward kernel as their gradient
    when one is wanted, or the call raises.
    """
    if q.device.type == "cpu" and not work.shape_only(q):
        return attention_ref(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)
    return flash_attention(q, k, v, causal=causal, window=window)


def _library() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, ctypes.c_int, i64, i64, i64, i64, i64,
                       i64, ctypes.c_int, i64, p]
        fn.restype = ctypes.c_int
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = _build.library("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p] * 10 + [ctypes.c_int, i64, i64, i64, i64, i64, i64,
                                  ctypes.c_int, i64, p]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, window, what="flash_attention", extra=()):
    """The checks both kernels share: devices, dtypes, shapes, layouts."""
    device = q.device
    if device.type != "cuda" and not work.shape_only(q):
        raise ValueError(f"{what} needs CUDA tensors, got {device}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{what}: q, k, v must be [B, S, heads, hd]")
    b, sq, h, hd = q.shape
    _, skv, kh, _ = k.shape
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}, "
                            f"expected {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    if tuple(k.shape) != (b, skv, kh, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{what}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    for name, t in extra:
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"{what}: {name} {tuple(t.shape)} does not "
                             f"match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd} not in {HEAD_DIMS}")
    if kh == 0 or h % kh:
        raise ValueError(f"{what}: {h} query heads over {kh} KV heads")
    if sq > skv or skv == 0:
        raise ValueError(f"{what}: needs 0 < Skv and Sq <= Skv, got "
                         f"Sq={sq}, Skv={skv}")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window {window} < 1")
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError(f"{what}: tensors above 2^31 elements")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, return_lse: bool = False):
    """Launch the CUDA kernel on the current stream (no synchronisation).

    q [B,Sq,H,hd], k/v [B,Skv,KH,hd], one dtype (f32 or bf16), contiguous,
    on one CUDA device; hd in ``HEAD_DIMS``; Sq <= Skv (queries start at
    key 0, as in the Pallas kernel); window None or >= 1.  With
    ``return_lse`` returns (out, lse), lse f32 [B,H,Sq] the log-sum-exp of
    each row's scaled scores, which the backward kernel reads.
    """
    _check(q, k, v, window)
    b, sq, h, hd = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if sq and b and h:
        _launch(q, k, v, out, lse, bool(causal), window)
    return (out, lse) if return_lse else out


def _fwd_flops(q, k, v, out, lse, causal, window):
    b, sq, h, hd = q
    return work.flash_flops(b, sq, k[1], h, hd, causal, window)


@work.kernel_op("flash_attention", ("out", "lse"), _fwd_flops)
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, lse: Optional[torch.Tensor], causal: bool,
            window: Optional[int]) -> None:
    """The forward kernel's launch into ``out`` (and ``lse``)."""
    b, sq, h, hd = q.shape
    _, skv, kh, _ = k.shape
    if (design(q.dtype, hd) == "wgmma-bf16"
            and any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("flash_attention: the tensor-core kernel copies "
                         "16-byte chunks: q, k, v must be 16-byte aligned")
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            _DTYPES[q.dtype], b, sq, skv, h, kh, hd,
            int(causal), window or 0, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: int | None = None):
    """Launch the backward kernel on the current stream (no
    synchronisation): (dq, dk, dv) in q's dtype, summed in f32.

    q, k, v as ``flash_attention`` takes them; ``out`` the forward's output
    and ``dout`` its gradient, q's shape and dtype; ``lse`` the forward's
    f32 [B,H,Sq].  Deterministic: no float atomics.
    """
    _check(q, k, v, window, "flash_attention_bwd",
           (("out", out), ("dout", dout)))
    b, sq, h, hd = q.shape
    _, skv, kh, _ = k.shape
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (b, h, sq) or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"f32 [{b}, {h}, {sq}] on {q.device}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if sq == 0 or b == 0 or h == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch_bwd(q, k, v, out, dout, lse, delta, dq, dk, dv, bool(causal),
                window)
    return dq, dk, dv


def _bwd_flops(q, k, v, *rest):
    b, sq, h, hd = q
    causal, window = rest[-2:]
    return work.FLASH_BWD_RATIO * work.flash_flops(b, sq, k[1], h, hd,
                                                   causal, window)


@work.kernel_op("flash_attention_bwd", ("delta", "dq", "dk", "dv"),
                _bwd_flops)
def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                delta: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor,
                dv: torch.Tensor, causal: bool,
                window: Optional[int]) -> None:
    """The backward kernel's launch into ``dq``, ``dk``, ``dv`` (its
    scratch: ``delta``, each row's dO . O)."""
    b, sq, h, hd = q.shape
    _, skv, kh, _ = k.shape
    if (bwd_design(q.dtype, hd) == "wgmma-bf16"
            and any(t.data_ptr() % 16 for t in (q, k, v, dout))):
        raise ValueError("flash_attention_bwd: the tensor-core kernels copy "
                         "16-byte chunks: q, k, v, dout must be 16-byte "
                         "aligned")
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype],
            b, sq, skv, h, kh, hd, int(causal), window or 0, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_bwd.launches += 1


flash_attention_bwd.launches = 0
