"""Dispatching wrapper for the selective-scan kernel: the hand-written CUDA
kernel for CUDA tensors, the plain PyTorch version for CPU tensors.

``selective_scan.launches`` counts the CUDA launches (a plain integer;
reset it by assignment).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

__all__ = ["selective_scan", "selective_scan_ref", "selective_scan_cuda",
           "STATE_SIZES"]

STATE_SIZES = (4, 8, 16)                # the kernel's instantiations of N


def selective_scan(dt, x, b_ssm, c_ssm, a, d_skip):
    """dt/x f32[B,S,di]; b/c f32[B,S,N]; a f32[di,N]; d f32[di] ->
    y f32[B,S,di].

    CPU tensors take ``selective_scan_ref``; CUDA tensors launch the
    kernel, or the call raises.
    """
    if x.device.type == "cpu":
        return selective_scan_ref(dt, x, b_ssm, c_ssm, a, d_skip)
    return selective_scan_cuda(dt, x, b_ssm, c_ssm, a, d_skip)


selective_scan.launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.library("selective_scan")
    fn = lib.selective_scan_launch
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, p, p, i64, i64, i64, i64, p]
        fn.restype = ctypes.c_int
    return lib


def selective_scan_cuda(dt, x, b_ssm, c_ssm, a, d_skip):
    """Launch the CUDA kernel on the current stream (no synchronisation).

    All inputs f32, contiguous, on one CUDA device; N in ``STATE_SIZES``.
    """
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"selective_scan_cuda needs CUDA tensors, got "
                         f"{device}")
    if x.ndim != 3 or a.ndim != 2:
        raise ValueError("selective_scan: x must be [B, S, di], a [di, N]")
    bsz, s, di = x.shape
    n = a.shape[1]
    shapes = {"dt": (dt, (bsz, s, di)), "x": (x, (bsz, s, di)),
              "b_ssm": (b_ssm, (bsz, s, n)), "c_ssm": (c_ssm, (bsz, s, n)),
              "a": (a, (di, n)), "d_skip": (d_skip, (di,))}
    for name, (t, shape) in shapes.items():
        if t.device != device:
            raise ValueError(f"selective_scan: {name} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"selective_scan: {name} has dtype {t.dtype}, "
                            f"expected torch.float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"selective_scan: {name} must be contiguous")
    if n not in STATE_SIZES:
        raise ValueError(f"selective_scan: state size {n} not in "
                         f"{STATE_SIZES}")
    if x.numel() >= 2 ** 31:
        raise ValueError("selective_scan: tensors above 2^31 elements")

    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.selective_scan_launch(
            dt.data_ptr(), x.data_ptr(), b_ssm.data_ptr(), c_ssm.data_ptr(),
            a.data_ptr(), d_skip.data_ptr(), y.data_ptr(), bsz, s, di, n,
            stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA "
                           f"error {err}")
    selective_scan.launches += 1
    return y
