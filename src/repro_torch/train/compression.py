"""Gradient compression: int8 block quantization with error feedback.

Port of ``repro.train.compression``'s ``quantize_int8``,
``dequantize_int8`` and ``ef_compress_tree``.  Each gradient leaf is
scaled per 256-element block to int8 (round half to even, clipped to
+-127); the quantization residual is carried in an f32 error buffer and
added back before the next round (EF-SGD).

Sharded leaves (``mesh`` and ``specs``: each gradient and error leaf is
this rank's block under its ``PartitionSpec``, as the train step holds
them under ``param_pspecs``): the round must be JAX's, whose
``ef_compress_tree`` sees the global leaf, blocks of 256 over its
row-major flattening.  A rank's block is not a run of whole 256-blocks
of the global leaf, so each rank works out the global flat index of
each of its elements, hence its 256-block; scatters ``max |x|`` into an
f32 vector of every block of the leaf; one ``pmax`` over the axes the
leaf is cut over gives every block's maximum; and each element is then
rounded on its own.  A maximum and an elementwise rounding do not depend
on the order of anything, so the wire and the new error block are,
bit for bit, this rank's block of the whole-leaf round (the zero padding
of the last block changes no maximum).  A leaf whose spec cuts nothing
of size > 1 takes the whole-leaf round.

``allreduce_compressed`` is the collective across ranks: each rank
quantizes its block to the int8 wire format and back, and one f32
all-reduce over a mesh axis sums the dequantized blocks (JAX's ``psum``
of the wire in ``shard_map``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.sharding.rules import spec_axes
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


def _round(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x`` to the int8 grid of ``scale`` (broadcast to it) and back:
    ``quantize_int8`` then ``dequantize_int8``, elementwise."""
    q = torch.round(x / torch.clamp(scale, min=1e-12))
    return torch.clamp(q, -127, 127).to(torch.int8).to(torch.float32) \
        * scale


def _global_flat_index(shape, spec, mesh, device) -> torch.Tensor:
    """i64 tensor of this rank's block shape under ``spec`` (``shape``
    the global leaf's): each element's index in the row-major flattening
    of the global leaf."""
    block = [n // (mesh.axis_size(e) if e is not None else 1)
             for n, e in zip(shape, spec)] + list(shape[len(spec):])
    idx, stride = None, 1
    for d in reversed(range(len(shape))):
        e = spec[d] if d < len(spec) else None
        start = (mesh.axis_index(e) if e is not None else 0) * block[d]
        ax = (torch.arange(block[d], dtype=torch.int64, device=device)
              + start) * stride
        ax = ax.view([-1] + [1] * (len(shape) - 1 - d))
        idx = ax if idx is None else ax + idx
        stride *= shape[d]
    return idx.expand(block)


def _sharded_leaf(g, e, spec, mesh):
    """(wire, new error) of this rank's block of one leaf: the blocks of
    the whole-leaf round on the gathered leaf (module docstring)."""
    x = g.to(torch.float32) + e
    axes = tuple(a for a in mesh.axis_names if a in spec_axes(spec, mesh))
    shape = [n * (mesh.axis_size(s) if s is not None else 1)
             for n, s in zip(x.shape, spec)] + list(x.shape[len(spec):])
    n = math.prod(shape)
    block = (_global_flat_index(shape, spec, mesh, x.device)
             // _BLOCK).reshape(-1)
    amax = torch.zeros((n + _BLOCK - 1) // _BLOCK, dtype=torch.float32,
                       device=x.device)
    amax.scatter_reduce_(0, block, torch.abs(x).reshape(-1), "amax")
    scale = mesh.pmax(amax, axes) / 127.0
    wire = _round(x.reshape(-1), scale[block]).view(x.shape)
    return wire, x - wire


def ef_compress_tree(grads, error_buf, mesh=None, specs=None):
    """Error-feedback round: returns (wire-format grads, new error buffer).

    wire = dequant(quant(g + e));  e' = (g + e) - wire.

    With ``mesh`` and ``specs`` (a tree of ``PartitionSpec`` like
    ``grads``), each leaf is this rank's block and the round is that of
    the global leaf (module docstring)."""
    def leaf(g, e):
        x = g.to(torch.float32) + e
        q, s, n = quantize_int8(x)
        wire = dequantize_int8(q, s, n, g.shape)
        return wire, x - wire

    _, flat_g, unflatten = tree_flatten(grads)
    flat_e = tree_leaves(error_buf)
    flat_s = [None] * len(flat_g) if specs is None else tree_leaves(specs)
    outs = [leaf(g, e) if s is None or not spec_axes(s, mesh)
            else _sharded_leaf(g, e, s, mesh)
            for g, e, s in zip(flat_g, flat_e, flat_s)]
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
