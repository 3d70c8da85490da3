"""The hand-written kernels as PyTorch operators, and their own work.

Each kernel's launch is a ``torch.library`` custom operator,
``repro_torch::<kernel>`` (``kernel_op``): its CUDA implementation
launches the kernel through ``ctypes``; its outputs and scratch are
arguments it writes, which the wrapper allocates.  Its fake
implementation writes nothing: on shape-only tensors (a ``FakeTensor``,
which the dry-run traces with; ``shape_only``) the operator stands in
for the launch, and the wrapper has allocated what a launch would.

``torch.utils.flop_counter.FlopCounterMode`` counts each operator by the
kernel's own algorithm (its formula is registered with the operator),
where it launches and where it stands in for a launch.  The plain
versions, which the CPU runs, do other work: plain attention multiplies
the whole S x S product and then masks it, the plain scan has no
product at all.  Any ``TorchDispatchMode`` sees the operator's operands
(``launch.cost_analysis.Tally`` counts their bytes).

The formulas:

- ``flash_attention``: 4 x D operations per (query, key) pair it visits
  (the products Q K^T and P V, two operations a multiply-add), for
  B x H query rows.  Causal, with queries from key 0, a row visits
  W = min(window or Sq, Sq) keys, Sq x W - W^2 / 2 pairs in all (S^2 / 2
  at Sq = Skv = S: 68.7 GFLOP at [4, 2048, 16/8, 128]); not causal,
  Sq x Skv.
- ``flash_attention_bwd``: 2.5 times the forward's (the products S, dP,
  dV, dK, dQ: five to the forward's two).
- ``selective_scan``: 7 operations a state element and step (exp(dt A),
  its product with h, the multiply-add of dt x B, the multiply-add of
  C h), B x S x di x N in all.
- ``selective_scan_bwd``: 23 a state element and step (pass 1's
  recurrence, 5; the states recomputed in the reverse pass, 5; the
  gradient, 13: dh, dC, dB, and d(dt A) into d dt and dA).
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

__all__ = ["kernel_op", "shape_only", "flash_flops", "scan_flops",
           "KERNELS"]

SCAN_FWD_OPS, SCAN_BWD_OPS = 7, 23
FLASH_BWD_RATIO = 2.5
KERNELS = ("flash_attention", "flash_attention_bwd", "selective_scan",
           "selective_scan_bwd")


def kernel_op(name: str, writes: tuple, flops):
    """Decorator: ``launch`` becomes the CUDA implementation of the
    operator ``repro_torch::name``, which writes the arguments ``writes``
    and returns nothing; its fake implementation writes nothing, and
    ``flops(*shapes)`` (each tensor argument by its shape) is its
    formula for ``FlopCounterMode``."""
    def register(launch):
        op = torch.library.custom_op(f"repro_torch::{name}", launch,
                                     mutates_args=writes,
                                     device_types="cuda")
        op.register_fake(lambda *args, **kwargs: None)
        register_flop_formula(getattr(torch.ops.repro_torch, name))(
            lambda *shapes, out_shape=None, **kwargs: flops(*shapes))
        return op
    return register


def shape_only(t: torch.Tensor) -> bool:
    """Whether ``t`` carries a shape and no data (a ``FakeTensor``): the
    dry-run's trace of a card's program, which takes the kernels' route
    wherever it is placed."""
    return isinstance(t, FakeTensor)


def flash_flops(b: int, sq: int, skv: int, h: int, hd: int, causal: bool,
                window) -> float:
    """The forward kernel's operations (see the module's docstring)."""
    if causal:
        w = min(window or sq, sq)
        pairs = sq * w - w * w / 2
    else:
        pairs = sq * skv
    return 4.0 * b * h * hd * pairs


def scan_flops(b: int, s: int, di: int, n: int, backward: bool) -> float:
    """The scan kernel's (or its backward's) operations."""
    return float((SCAN_BWD_OPS if backward else SCAN_FWD_OPS)
                 * b * s * di * n)
