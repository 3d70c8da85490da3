"""Gradient compression: int8 block quantization with error feedback.

Port of ``repro.train.compression``'s ``quantize_int8``,
``dequantize_int8`` and ``ef_compress_tree``.  Each gradient leaf is
scaled per 256-element block to int8 (round half to even, clipped to
+-127); the quantization residual is carried in an f32 error buffer and
added back before the next round (EF-SGD).

``allreduce_compressed`` is the collective across ranks: each rank
quantizes its block to the int8 wire format and back, and one f32
all-reduce over a mesh axis sums the dequantized blocks (JAX's ``psum``
of the wire in ``shard_map``).
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_flatten, tree_leaves

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress_tree",
           "allreduce_compressed"]

_BLOCK = 256


def _pad_to_block(x: torch.Tensor):
    n = x.numel()
    pad = (-n) % _BLOCK
    flat = torch.nn.functional.pad(x.reshape(-1), (0, pad))
    return flat.reshape(-1, _BLOCK), n


def quantize_int8(x: torch.Tensor):
    """f32/bf16 -> (int8 payload [Nb,256], f32 scales [Nb], orig size)."""
    blocks, n = _pad_to_block(x.to(torch.float32))
    scale = torch.amax(torch.abs(blocks), dim=1) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)[:, None])
    q = torch.clamp(q, -127, 127).to(torch.int8)
    return q, scale, n


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, n: int, shape,
                    dtype=torch.float32) -> torch.Tensor:
    out = (q.to(torch.float32) * scale[:, None]).reshape(-1)[:n]
    return out.reshape(shape).to(dtype)


def ef_compress_tree(grads, error_buf):
    """Error-feedback round: returns (wire-format grads, new error buffer).

    wire = dequant(quant(g + e));  e' = (g + e) - wire.
    """
    def leaf(g, e):
        x = g.to(torch.float32) + e
        q, s, n = quantize_int8(x)
        wire = dequantize_int8(q, s, n, g.shape)
        return wire, x - wire

    _, flat_g, unflatten = tree_flatten(grads)
    flat_e = tree_leaves(error_buf)
    outs = [leaf(g, e) for g, e in zip(flat_g, flat_e)]
    return unflatten([o[0] for o in outs]), unflatten([o[1] for o in outs])


def allreduce_compressed(mesh, axis: str, tree):
    """Mean over ``axis`` with the int8 wire format: each rank passes its
    own block (a tree), and every rank gets back the same mean, in f32.
    Each leaf is quantized to int8 and dequantized; one f32 all-reduce
    (SUM) over the axis's group sums the dequantized leaves, which are
    then divided by the axis's size."""
    _, leaves, unflatten = tree_flatten(tree)
    wires = [dequantize_int8(*quantize_int8(x), x.shape) for x in leaves]
    flat = torch.cat([w.reshape(-1) for w in wires])
    mesh.all_reduce_(flat, axis)
    n, out, at = mesh.axis_size(axis), [], 0
    for w in wires:
        out.append(flat[at:at + w.numel()].view(w.shape) / n)
        at += w.numel()
    return unflatten(out)
