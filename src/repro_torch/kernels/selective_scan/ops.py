"""Dispatching wrapper for the selective-scan kernel: the hand-written CUDA
kernel for CUDA tensors, the plain PyTorch version for CPU tensors.

Gradients: ``selective_scan`` on CUDA tensors that need one is a
``torch.autograd.Function`` whose forward is the forward kernel and whose
backward is the hand-written ``selective_scan_bwd`` kernel
(``csrc/selective_scan_bwd.cu``, design ``BWD_DESIGN``: cp.async-staged
32-step chunks, h saved every chunk in a first pass and each chunk's
states recomputed in registers in the reverse pass, so the forward
saves only its inputs).  On CPU tensors the
gradient is autograd through ``selective_scan_ref``.  Without a gradient
the call is the forward launch alone, as before.

``selective_scan.launches`` and ``selective_scan_bwd.launches`` count the
CUDA launches (plain integers; reset them by assignment).  Each kernel
launches as the operator ``repro_torch::selective_scan`` (``_bwd``),
with its flop formula (``kernels.work``); shape-only tensors
(``work.shape_only``, the dry-run's) take the CUDA route, where the
operator launches nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

__all__ = ["selective_scan", "selective_scan_ref", "selective_scan_cuda",
           "selective_scan_bwd", "bwd_blocks_per_sm", "STATE_SIZES",
           "BWD_DESIGN"]

STATE_SIZES = (4, 8, 16)                # the kernels' instantiations of N
BWD_DESIGN = "staged-recompute"         # the backward kernel's design
_BWD_CHUNK = 32                         # csrc/selective_scan_bwd.cu's TCH
_BWD_CHANNELS = 32                      # ... and its CPB


class _SelectiveScan(torch.autograd.Function):
    """The forward kernel, and the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, dt, x, b_ssm, c_ssm, a, d_skip):
        ctx.save_for_backward(dt, x, b_ssm, c_ssm, a, d_skip)
        return selective_scan_cuda(dt, x, b_ssm, c_ssm, a, d_skip)

    @staticmethod
    def backward(ctx, dy):
        return selective_scan_bwd(*ctx.saved_tensors, dy.contiguous())


def selective_scan(dt, x, b_ssm, c_ssm, a, d_skip):
    """dt/x f32[B,S,di]; b/c f32[B,S,N]; a f32[di,N]; d f32[di] ->
    y f32[B,S,di].

    CPU tensors take ``selective_scan_ref`` (autograd differentiates it);
    CUDA tensors launch the kernel, with the backward kernel as their
    gradient when one is wanted, or the call raises.
    """
    if x.device.type == "cpu" and not work.shape_only(x):
        return selective_scan_ref(dt, x, b_ssm, c_ssm, a, d_skip)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, x, b_ssm, c_ssm, a, d_skip)):
        return _SelectiveScan.apply(dt, x, b_ssm, c_ssm, a, d_skip)
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


def _bwd_library() -> ctypes.CDLL:
    lib = _build.library("selective_scan_bwd")
    fn = lib.selective_scan_bwd_launch
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p] * 18 + [i64, i64, i64, i64, p]
        fn.restype = ctypes.c_int
        occ = lib.selective_scan_bwd_blocks_per_sm
        occ.argtypes, occ.restype = [i64], ctypes.c_int
    return lib


def bwd_blocks_per_sm(n: int) -> int:
    """Blocks of the backward kernel at state size ``n`` that fit on one SM
    of the current CUDA device (by its shared memory, registers and
    threads)."""
    if n not in STATE_SIZES:
        raise ValueError(f"selective_scan_bwd: state size {n} not in "
                         f"{STATE_SIZES}")
    blocks = _bwd_library().selective_scan_bwd_blocks_per_sm(n)
    if blocks < 0:
        raise RuntimeError("selective_scan_bwd: occupancy query failed")
    return blocks


def _check(tensors: dict, what: str):
    """Every input on one CUDA device, f32, of its shape, contiguous; N in
    ``STATE_SIZES``.  ``tensors`` maps a name to (tensor, shape)."""
    device = tensors["x"][0].device
    if device.type != "cuda" and not work.shape_only(tensors["x"][0]):
        raise ValueError(f"{what} needs CUDA tensors, got {device}")
    for name, (t, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}, "
                            f"expected torch.float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    n = tensors["a"][1][1]
    if n not in STATE_SIZES:
        raise ValueError(f"{what}: state size {n} not in {STATE_SIZES}")
    if tensors["x"][0].numel() >= 2 ** 31:
        raise ValueError(f"{what}: tensors above 2^31 elements")


def _shapes(dt, x, b_ssm, c_ssm, a, d_skip, what):
    if x.ndim != 3 or a.ndim != 2:
        raise ValueError(f"{what}: x must be [B, S, di], a [di, N]")
    bsz, s, di = x.shape
    n = a.shape[1]
    return {"dt": (dt, (bsz, s, di)), "x": (x, (bsz, s, di)),
            "b_ssm": (b_ssm, (bsz, s, n)), "c_ssm": (c_ssm, (bsz, s, n)),
            "a": (a, (di, n)), "d_skip": (d_skip, (di,))}


def selective_scan_cuda(dt, x, b_ssm, c_ssm, a, d_skip):
    """Launch the CUDA kernel on the current stream (no synchronisation).

    All inputs f32, contiguous, on one CUDA device; N in ``STATE_SIZES``.
    """
    _check(_shapes(dt, x, b_ssm, c_ssm, a, d_skip, "selective_scan"),
           "selective_scan")
    y = torch.empty_like(x)
    if x.numel():
        _launch(dt, x, b_ssm, c_ssm, a, d_skip, y)
    return y


@work.kernel_op("selective_scan", ("y",), lambda dt, x, b, c, a, *_:
                work.scan_flops(*x, a[1], backward=False))
def _launch(dt: torch.Tensor, x: torch.Tensor, b_ssm: torch.Tensor,
            c_ssm: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
            y: torch.Tensor) -> None:
    """The forward kernel's launch into ``y``."""
    bsz, s, di = x.shape
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.selective_scan_launch(
            dt.data_ptr(), x.data_ptr(), b_ssm.data_ptr(), c_ssm.data_ptr(),
            a.data_ptr(), d_skip.data_ptr(), y.data_ptr(), bsz, s, di,
            a.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA "
                           f"error {err}")
    selective_scan.launches += 1


def selective_scan_bwd(dt, x, b_ssm, c_ssm, a, d_skip, dy):
    """Launch the backward kernel on the current stream (no
    synchronisation): given the forward's inputs and dy f32[B,S,di],
    returns (d dt, dx, dB, dC, dA, dD), f32 in the inputs' shapes.

    Deterministic: the sums over channels (dB, dC) and over batch and time
    (dA, dD) run through per-block partials and a fixed-order second pass.
    """
    shapes = _shapes(dt, x, b_ssm, c_ssm, a, d_skip, "selective_scan_bwd")
    shapes["dy"] = (dy, tuple(x.shape))
    _check(shapes, "selective_scan_bwd")
    bsz, s, di = x.shape
    n = a.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    ddt, dx = torch.empty_like(x), torch.empty_like(x)
    db, dc = torch.empty_like(b_ssm), torch.empty_like(c_ssm)
    da, dd = torch.empty_like(a), torch.empty_like(d_skip)
    if x.numel() == 0:
        return ddt, dx, db.zero_(), dc.zero_(), da.zero_(), dd.zero_()
    blocks = -(-di // _BWD_CHANNELS)
    hs = torch.empty((bsz, -(-s // _BWD_CHUNK), di, n), **f32)
    pb = torch.empty((blocks, bsz, s, n), **f32)
    pc = torch.empty((blocks, bsz, s, n), **f32)
    pa = torch.empty((bsz, di, n), **f32)
    pd = torch.empty((bsz, di), **f32)
    grads = (ddt, dx, db, dc, da, dd)
    _launch_bwd(dt, x, b_ssm, c_ssm, a, d_skip, dy, hs, pb, pc, pa, pd,
                *grads)
    return grads


@work.kernel_op("selective_scan_bwd",
                ("hs", "pb", "pc", "pa", "pd", "ddt", "dx", "db", "dc",
                 "da", "dd"),
                lambda dt, x, b, c, a, *_: work.scan_flops(
                    *x, a[1], backward=True))
def _launch_bwd(dt: torch.Tensor, x: torch.Tensor, b_ssm: torch.Tensor,
                c_ssm: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                dy: torch.Tensor, hs: torch.Tensor, pb: torch.Tensor,
                pc: torch.Tensor, pa: torch.Tensor, pd: torch.Tensor,
                ddt: torch.Tensor, dx: torch.Tensor, db: torch.Tensor,
                dc: torch.Tensor, da: torch.Tensor,
                dd: torch.Tensor) -> None:
    """The backward kernel's launch into the six gradients (its scratch:
    the chunk-start states ``hs`` and the per-block partials)."""
    bsz, s, di = x.shape
    lib = _bwd_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.selective_scan_bwd_launch(
            *(t.data_ptr() for t in (dt, x, b_ssm, c_ssm, a, d_skip, dy, hs,
                                     pb, pc, pa, pd, ddt, dx, db, dc, da,
                                     dd)),
            bsz, s, di, a.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd kernel launch failed: CUDA "
                           f"error {err}")
    selective_scan_bwd.launches += 1


selective_scan_bwd.launches = 0
