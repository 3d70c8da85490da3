"""Carry a scenario state across packages, leaf by leaf.

``from_arrays`` walks the port's dataclass fields by name and takes
``np.asarray`` of the same-named leaf of any object that has them — a
JAX ``DatacenterState``, a tree of numpy arrays (attributes or dict
keys), or a port state — so scenarios built by either package run in
either.  The same goes for any other port dataclass (``cls=``), such as
a stream (``state.ArrivalStream``) or its carry (``state.StreamState``).
``to_numpy`` goes the other way.  Dtypes (``bool``, ``int32``,
``float32``) and 0-d scalars are kept exactly.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from repro_torch.core import state as S
from repro_torch.device import resolve_device

__all__ = ["from_arrays", "to_numpy"]


def _leaf(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _build(cls, obj, device):
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        src = _leaf(obj, f.name)
        sub = hints[f.name]
        if dataclasses.is_dataclass(sub):
            kw[f.name] = _build(sub, src, device)
        elif isinstance(src, torch.Tensor):
            kw[f.name] = src.detach().to(device)
        else:
            kw[f.name] = torch.from_numpy(np.array(src)).to(device)
    return cls(**kw)


def from_arrays(obj, device=None, cls=S.DatacenterState):
    """A port ``cls`` (default ``DatacenterState``) from any object with
    the same field names, on ``device``."""
    return _build(cls, obj, resolve_device(device))


def to_numpy(state):
    """The same dataclass tree with every leaf a numpy array."""
    return S.map_tensors(lambda t: t.detach().cpu().numpy(), state)
