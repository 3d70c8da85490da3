"""Dispatching wrapper for the simstep kernel: the hand-written CUDA kernel
for CUDA tensors, the plain PyTorch version for CPU tensors.

``simstep.launches`` counts the CUDA launches (a plain integer; reset it
by assignment).  ``dense_index`` maps the flat, ragged, grouped-by-VM
cloudlet axis onto the kernel's dense [V, Kmax] tile.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.simstep.ref import INF, simstep_ref

__all__ = ["simstep", "simstep_ref", "simstep_cuda", "DenseIndex",
           "dense_index", "to_dense", "from_dense"]


def simstep(remaining, runnable, vm_capacity, req_pes, task_policy):
    """Fused VM-level share computation + earliest-completion reduction.

    CPU tensors take ``simstep_ref``; CUDA tensors launch the kernel, or
    the call raises.
    """
    if remaining.device.type == "cpu":
        return simstep_ref(remaining, runnable, vm_capacity, req_pes,
                           task_policy)
    return simstep_cuda(remaining, runnable, vm_capacity, req_pes,
                        task_policy)


simstep.launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.library("simstep")
    fn = lib.simstep_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, p, ctypes.c_int64, ctypes.c_int64,
                       p]
        fn.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"simstep: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"simstep: {name} has dtype {t.dtype}, expected "
                        f"{dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"simstep: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"simstep: {name} must be contiguous")


def simstep_cuda(remaining, runnable, vm_capacity, req_pes, task_policy):
    """Launch the CUDA kernel on the current stream (no synchronisation).

    remaining f32[V,K], runnable bool[V,K], vm_capacity f32[V] and
    req_pes f32[V] on one CUDA device; task_policy an int or an i32[]
    tensor there.  Returns (rates f32[V,K], dt_min f32[V]).
    """
    device = remaining.device
    if device.type != "cuda":
        raise ValueError(f"simstep_cuda needs CUDA tensors, got {device}")
    if remaining.ndim != 2:
        raise ValueError("simstep: remaining must be [V, K]")
    v, k = remaining.shape
    _check("remaining", remaining, torch.float32, (v, k), device)
    _check("runnable", runnable, torch.bool, (v, k), device)
    _check("vm_capacity", vm_capacity, torch.float32, (v,), device)
    _check("req_pes", req_pes, torch.float32, (v,), device)
    if not isinstance(task_policy, torch.Tensor):
        task_policy = torch.tensor(int(task_policy), dtype=torch.int32,
                                   device=device)
    _check("task_policy", task_policy, torch.int32, (), device)

    rates = torch.empty((v, k), dtype=torch.float32, device=device)
    dt_min = torch.empty((v,), dtype=torch.float32, device=device)
    if v == 0:
        return rates, dt_min
    if k == 0:
        return rates, dt_min.fill_(INF)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.simstep_launch(
            remaining.data_ptr(), runnable.data_ptr(),
            vm_capacity.data_ptr(), req_pes.data_ptr(),
            task_policy.data_ptr(), rates.data_ptr(), dt_min.data_ptr(),
            v, k, stream)
    if err != 0:
        raise RuntimeError(f"simstep kernel launch failed: CUDA error {err}")
    simstep.launches += 1
    return rates, dt_min


@dataclasses.dataclass
class DenseIndex:
    """Map between the flat cloudlet axis [C] and the dense tile [V, K].

    Row r holds, in slot order, the slots with ``vm == r``; the grouped
    invariant of ``state.make_cloudlets`` makes them one contiguous run.
    Cells past a row's last slot are padding.  Slots with ``vm`` outside
    [0, V) appear in no row.
    """
    slot: torch.Tensor      # i64[V, K] flat slot of each cell (0 on padding)
    pad: torch.Tensor       # bool[V, K] padding cell
    cell: torch.Tensor      # i64[C] flattened dense cell of each slot
    placed: torch.Tensor    # bool[C] slot has a row (0 <= vm < V)


def dense_index(cl_vm: torch.Tensor, n_vms: int) -> DenseIndex:
    """Build the flat<->dense map for ``cl_vm`` (one host sync for Kmax).

    On the static path ``cl.vm`` never changes, so a run builds it once.
    """
    dev = cl_vm.device
    vm = cl_vm.long()
    placed = (vm >= 0) & (vm < n_vms)
    slots = torch.nonzero(placed).view(-1)                  # slot order
    owner = vm[slots]
    order = torch.argsort(owner, stable=True)
    slots, owner = slots[order], owner[order]
    counts = torch.bincount(owner, minlength=n_vms)
    k = int(counts.max()) if n_vms and slots.numel() else 0
    starts = torch.cumsum(counts, 0) - counts
    col = torch.arange(slots.numel(), device=dev) - starts[owner]
    slot = torch.zeros((n_vms, k), dtype=torch.long, device=dev)
    pad = torch.ones((n_vms, k), dtype=torch.bool, device=dev)
    slot[owner, col] = slots
    pad[owner, col] = False
    cell = torch.zeros(vm.shape, dtype=torch.long, device=dev)
    cell[slots] = owner * k + col
    return DenseIndex(slot=slot, pad=pad, cell=cell, placed=placed)


def to_dense(index: DenseIndex, values: torch.Tensor, fill):
    """Flat [C] -> dense [V, K]; padding cells hold ``fill``."""
    return torch.where(index.pad, fill, values[index.slot])


def from_dense(index: DenseIndex, dense: torch.Tensor, fill):
    """Dense [V, K] -> flat [C]; slots without a row hold ``fill``."""
    if dense.numel() == 0:
        return torch.full(index.cell.shape, fill, dtype=dense.dtype,
                          device=dense.device)
    return torch.where(index.placed, dense.reshape(-1)[index.cell], fill)
