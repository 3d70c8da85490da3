"""Dispatching wrappers for the simstep kernel: the hand-written CUDA kernel
for CUDA tensors, the plain PyTorch version for CPU tensors.

``simstep.launches`` counts the CUDA calls (a plain integer; reset it by
assignment).  ``row_index`` describes the flat, ragged, grouped-by-VM
cloudlet axis as one contiguous run of slots per VM row, which
``simstep_ragged`` reads directly: nothing here holds a [V, Kmax] tile.
``padded_row_index`` builds the same index with every size fixed by the
slot count, so it needs no host read: a streamed window regroups its
recycled slots at every admission and rebuilds it on the device.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from repro_torch.kernels import _build
from repro_torch.spans import span
from repro_torch.kernels.simstep.ref import (INF, simstep_ragged_ref,
                                             simstep_ref)

__all__ = ["simstep", "simstep_ref", "simstep_ragged", "simstep_ragged_ref",
           "RowIndex", "row_index", "padded_row_index", "WINDOW", "CHUNK"]

WINDOW = 32     # slots a warp of the short-row kernel takes
CHUNK = 1024    # slots of a long row per block (simstep.cu's kChunk)


@dataclasses.dataclass
class RowIndex:
    """The VM rows of the flat cloudlet axis [C].

    Row r is the contiguous run of slots with ``vm == r`` (the grouped
    invariant of ``state.make_cloudlets``).  Slots with ``vm`` outside
    [0, V) belong to no row.  ``window`` cuts [0, C) into spans that each
    start at a row's first slot or at a slot of no row: whole short rows
    (at most ``WINDOW`` slots) and slots of no row packed greedily into
    spans of at most ``WINDOW`` slots, and each long row (more than
    ``WINDOW`` slots) alone in a span of its own.  Long rows are also cut
    into chunks of ``CHUNK`` slots.  Everything is O(C + V).

    A padded index (``padded_row_index``) ends ``window`` with empty
    spans [C, C] and fills ``empty`` and ``chunk_row`` with -1: entries
    the kernel skips.
    """
    slot_row: torch.Tensor      # i32[C] row of each slot, -1 without one
    start: torch.Tensor         # i32[V] first slot of each row (0 if empty)
    length: torch.Tensor        # i32[V] slots in each row
    window: torch.Tensor        # i32[W + 1] span starts, then C
    empty: torch.Tensor         # i32[E] rows without a slot
    chunk_row: torch.Tensor     # i32[NCH] the long row of each chunk
    chunk_first: torch.Tensor   # i32[NCH] that row's first chunk

    @property
    def n_slots(self) -> int:
        return self.slot_row.shape[0]

    @property
    def n_rows(self) -> int:
        return self.start.shape[0]


def max_spans(c: int) -> int:
    """Most spans ``RowIndex.window`` can cut C slots into.  Two
    consecutive spans hold more than ``WINDOW`` slots together (the
    second starts past the first's reach), so there are at most
    2 * floor(C / (WINDOW + 1)) + 1 of them, and never more than C."""
    return min(c, 2 * (c // (WINDOW + 1)) + 1)


def _window_marks(slot_row: torch.Tensor) -> torch.Tensor:
    """bool[C + 1]: the span starts of ``RowIndex.window``, and C.

    From a boundary b (a row's first slot, a slot of no row, or C) the next
    span starts at the last boundary <= b + WINDOW, or, when that is b
    itself (a long row), at the boundary after b.  The chain of starts
    from 0 is marked by pointer doubling: after round k the first 2^(k+1)
    starts are marked, so ceil(log2(max_spans(C) + 1)) + 1 rounds of a
    scatter and a gather over C + 1 positions mark them all, with no host
    loop.  Other positions point at themselves, so few of them meet in one
    target.
    """
    c = slot_row.shape[0]
    dev = slot_row.device
    pos = torch.arange(c + 1, device=dev)
    is_b = torch.ones(c + 1, dtype=torch.bool, device=dev)
    is_b[1:c] = (slot_row[1:] != slot_row[:-1]) | (slot_row[1:] < 0)
    # the k-th boundary is bounds[k]; n_b[x] boundaries lie at or before x
    # (a cumsum, not cummax: PyTorch scans a 1-D cummax in one CUDA block)
    n_b = torch.cumsum(is_b, 0)
    bounds = torch.zeros(c + 2, dtype=torch.long, device=dev).scatter_(
        0, torch.where(is_b, n_b - 1, c + 1), pos)
    ahead = torch.clamp(pos + WINDOW, max=c)
    reach = bounds[n_b[ahead] - 1]              # last boundary <= x + WINDOW
    after = torch.clamp(pos + 1, max=c)
    jump = torch.where(~is_b, pos, torch.where(
        reach > pos, reach, bounds[n_b[after] - is_b[after].long()]))
    marks = (pos == 0).to(torch.int32)
    for _ in range(max(1, math.ceil(math.log2(max_spans(c) + 1))) + 1):
        marks = marks.scatter_reduce(0, jump, marks, "amax")
        jump = jump[jump]
    return marks.bool() | (pos == c)           # no host-to-device copy


def row_index(cl_vm: torch.Tensor, n_vms: int) -> RowIndex:
    """Build the rows of ``cl_vm`` (i32[C] VM id per slot) with one host
    sync.  Raises ``ValueError`` when the slots of a VM are not one
    contiguous run.  A resident run never changes ``cl.vm``, so it builds
    the index once; a streamed window uses ``padded_row_index``."""
    dev = cl_vm.device
    vm = cl_vm.long()
    c = vm.shape[0]
    placed = (vm >= 0) & (vm < n_vms)
    slot_row = torch.where(placed, vm, -1).to(torch.int32)
    owner = torch.where(placed, vm, n_vms)      # a spare row takes the rest
    pos = torch.arange(c, device=dev)
    with span("sync.index.bincount"):     # checks the ids' range: 2 reads
        length = torch.bincount(owner, minlength=n_vms + 1)[:n_vms]
    first = torch.full((n_vms + 1,), c, dtype=torch.long,
                       device=dev).scatter_reduce(0, owner, pos, "amin")
    last = torch.full((n_vms + 1,), -1, dtype=torch.long,
                      device=dev).scatter_reduce(0, owner, pos, "amax")
    has = length > 0
    split = has & (last[:n_vms] - first[:n_vms] + 1 != length)
    row_chunks = torch.where(length > WINDOW, (length + CHUNK - 1) // CHUNK,
                             0)
    marks = _window_marks(slot_row)
    counts = torch.stack(
        [split.sum(), row_chunks.sum(), (~has).sum(), marks.sum()])
    with span("sync.index.counts"):
        n_split, n_chunks, n_empty, n_marks = counts.tolist()
    del counts      # its block is free for the index's tensors
    if n_split:
        bad = torch.nonzero(split).view(-1)[:8].tolist()
        raise ValueError(
            "cloudlet slots must be grouped by vm (the invariant "
            "state.validate_cloudlet_order checks): the slots of VM(s) "
            f"{bad} are not one contiguous run")
    # stable argsorts list the marked positions and the empty rows in order
    window = torch.argsort((~marks).to(torch.int8), stable=True)[:n_marks]
    empty = torch.argsort(has.to(torch.int8), stable=True)[:n_empty]
    ends = torch.cumsum(row_chunks, 0)
    chunk_row = torch.searchsorted(
        ends, torch.arange(n_chunks, device=dev), right=True)
    i32 = lambda t: t.to(torch.int32)
    return RowIndex(slot_row=slot_row,
                    start=i32(torch.where(has, first[:n_vms], 0)),
                    length=i32(length), window=i32(window), empty=i32(empty),
                    chunk_row=i32(chunk_row),
                    chunk_first=i32(ends[chunk_row] - row_chunks[chunk_row]))


def padded_row_index(slot_row: torch.Tensor, n_rows: int) -> RowIndex:
    """The ``RowIndex`` of a grouped axis, with no host read.

    ``slot_row`` (i32[C]) holds each slot's row, ascending, with the
    slots of no row (-1) last, as a sort by row leaves them.  Every size
    is fixed by C and ``n_rows``: ``window`` holds ``max_spans(C) + 1``
    entries, the real starts then C repeated (empty spans); ``empty``
    holds each row's id when it has no slot, else -1; the chunk lists
    hold ``C // (WINDOW + 1)`` entries (a long row has more than WINDOW
    slots and at most one chunk per WINDOW + 1 of them), -1 past the
    last chunk.  The grouping holds by construction, so nothing checks
    it."""
    dev = slot_row.device
    c = slot_row.shape[0]
    row = slot_row.long()
    owner = torch.where(row >= 0, row, n_rows)
    # index_add_, not bincount, which reads its input's max on the host
    length = torch.zeros(n_rows + 1, dtype=torch.long, device=dev).index_add_(
        0, owner, torch.ones_like(owner))[:n_rows]
    has = length > 0
    first = torch.cumsum(length, 0) - length        # rows are ascending
    marks = _window_marks(slot_row)
    n_span = max_spans(c)
    at = torch.where(marks, torch.cumsum(marks.long(), 0) - 1, n_span + 1)
    window = torch.full((n_span + 2,), c, dtype=torch.long,
                        device=dev).scatter_(
        0, at, torch.arange(c + 1, device=dev))[:n_span + 1]
    rows = torch.arange(n_rows, device=dev)
    row_chunks = torch.where(length > WINDOW, (length + CHUNK - 1) // CHUNK,
                             0)
    ends = torch.cumsum(row_chunks, 0)
    chunk_row = torch.searchsorted(
        ends, torch.arange(c // (WINDOW + 1), device=dev), right=True)
    real = chunk_row < n_rows
    cr = torch.clamp(chunk_row, max=max(n_rows - 1, 0))
    i32 = lambda t: t.to(torch.int32)
    return RowIndex(slot_row=i32(slot_row), start=i32(first * has),
                    length=i32(length), window=i32(window),
                    empty=i32(rows.masked_fill(has, -1)),
                    chunk_row=i32(chunk_row.masked_fill(~real, -1)),
                    chunk_first=i32((ends[cr] - row_chunks[cr]) * real))


def simstep_ragged(remaining, runnable, index: RowIndex, vm_capacity,
                   req_pes, task_policy):
    """Fused VM-level share computation + earliest-completion reduction on
    the flat cloudlet axis.

    remaining f32[C], runnable bool[C], ``index`` a ``RowIndex`` of C
    slots and V rows, vm_capacity and req_pes f32[V]; task_policy an int,
    an i32[] tensor, or an i32[V] tensor that gives each row its own
    policy (a batch of lanes flattened into one axis of rows).  Returns
    (rates f32[C], dt_min f32[V]).  CPU
    tensors take ``simstep_ragged_ref``; CUDA tensors launch the kernel
    on the current stream (no synchronisation), or the call raises.
    """
    device = remaining.device
    if device.type == "cpu":
        return simstep_ragged_ref(remaining, runnable, index, vm_capacity,
                                  req_pes, task_policy)
    if device.type != "cuda":
        raise ValueError(f"simstep_ragged needs CPU or CUDA tensors, got "
                         f"{device}")
    c, v = index.n_slots, index.n_rows
    _check("remaining", remaining, torch.float32, (c,), device)
    _check("runnable", runnable, torch.bool, (c,), device)
    _check("vm_capacity", vm_capacity, torch.float32, (v,), device)
    _check("req_pes", req_pes, torch.float32, (v,), device)
    for name in ("slot_row", "start", "length", "window", "empty",
                 "chunk_row", "chunk_first"):
        t = getattr(index, name)
        _check(f"index.{name}", t, torch.int32, tuple(t.shape), device)
    if not isinstance(task_policy, torch.Tensor):
        task_policy = torch.tensor(int(task_policy), dtype=torch.int32,
                                   device=device)
    per_row = task_policy.ndim == 1
    _check("task_policy", task_policy, torch.int32, (v,) if per_row else (),
           device)

    rates = torch.empty((c,), dtype=torch.float32, device=device)
    dt_min = torch.empty((v,), dtype=torch.float32, device=device)
    if c == 0:
        return rates, dt_min.fill_(INF)
    n_chunks = index.chunk_row.shape[0]
    chunk_count = torch.empty((n_chunks,), dtype=torch.int32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.simstep_ragged_launch(
            remaining.data_ptr(), runnable.data_ptr(),
            index.slot_row.data_ptr(), vm_capacity.data_ptr(),
            req_pes.data_ptr(), task_policy.data_ptr(), int(per_row),
            index.window.data_ptr(), index.window.shape[0] - 1,
            index.empty.data_ptr(), index.empty.shape[0],
            index.start.data_ptr(), index.length.data_ptr(),
            index.chunk_row.data_ptr(), index.chunk_first.data_ptr(),
            n_chunks, chunk_count.data_ptr(), rates.data_ptr(),
            dt_min.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"simstep kernel launch failed: CUDA error {err}")
    simstep.launches += 1
    return rates, dt_min


def simstep(remaining, runnable, vm_capacity, req_pes, task_policy):
    """``simstep_ragged`` on the dense [V, K] layout of the JAX reference:
    row v holds slots v*K .. v*K + K - 1.

    task_policy as for ``simstep_ragged``.  CPU tensors take
    ``simstep_ref``; CUDA tensors launch the kernel, or the call raises.
    Returns (rates f32[V, K], dt_min f32[V]).
    """
    if remaining.device.type == "cpu":
        return simstep_ref(remaining, runnable, vm_capacity, req_pes,
                           task_policy)
    if remaining.ndim != 2 or runnable.shape != remaining.shape:
        raise ValueError("simstep: remaining and runnable must be [V, K]")
    if not (remaining.is_contiguous() and runnable.is_contiguous()):
        raise ValueError("simstep: remaining and runnable must be "
                         "contiguous")
    v, k = remaining.shape
    rows = torch.arange(v, dtype=torch.int32, device=remaining.device)
    index = row_index(rows.repeat_interleave(k), v)
    rates, dt_min = simstep_ragged(remaining.reshape(-1),
                                   runnable.reshape(-1), index, vm_capacity,
                                   req_pes, task_policy)
    return rates.view(v, k), dt_min


simstep.launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.library("simstep")
    fn = lib.simstep_ragged_launch
    if fn.argtypes is None:
        p, n = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_int, p, n, p, n, p, p, p,
                       p, n, p, p, p, p]
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
