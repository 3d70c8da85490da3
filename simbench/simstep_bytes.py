"""The least work of one ``simstep`` launch, and the card's peaks.

A frozen copy of ``chip_smoke.py::simstep_bound``, reading the sizes of
the kernel's row index from the slot layout that the benchmark itself
generated (``index_sizes``), not from the program's index: each slot's
remaining, runnable and row id read and its rate written, each row's
capacity and PEs (and, with a policy a row, its task policy) read and
its dt_min written, the window table, the empty-row list, the chunk
table and the long rows' start and length read once.  Each byte is
counted once, whatever the kernel reads again.
"""
from __future__ import annotations

import numpy as np

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "WINDOW", "CHUNK",
           "KERNELS", "index_sizes", "launch_bytes", "launch_ops"]

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet, 700 W)
F32_OPS_PER_S = 67e12       # H100 SXM float32, outside tensor cores
WINDOW = 32                 # slots a warp of the short-row kernel takes
CHUNK = 1024                # slots of a long row per block
# the device functions of one launch, as the trace names them
KERNELS = ("window_kernel", "long_count_kernel", "long_rate_kernel")


def index_sizes(slot_row: np.ndarray, n_rows: int) -> dict:
    """The sizes of the row index of a grouped slot axis: ``slot_row``
    holds each slot's row (-1 for none), each row one contiguous run.

    Spans are cut greedily from slot 0: from a boundary (a row's first
    slot or a slot of no row) the next span starts at the last boundary
    within ``WINDOW`` slots, or, for a longer row, at the boundary after
    it."""
    row = np.asarray(slot_row, np.int64)
    c = row.size
    is_b = np.ones(c, bool)
    if c:
        is_b[1:] = (row[1:] != row[:-1]) | (row[1:] < 0)
    bounds = np.append(np.flatnonzero(is_b), c)
    reach = np.searchsorted(bounds, np.minimum(bounds[:-1] + WINDOW, c),
                            side="right") - 1
    k = np.arange(bounds.size - 1)
    nxt = np.where(reach > k, reach, k + 1).tolist()
    spans, at, last = 0, 0, bounds.size - 1
    while at < last:
        at = nxt[at]
        spans += 1
    length = np.bincount(row[row >= 0], minlength=n_rows)[:n_rows]
    long = length > WINDOW
    return {"n_slots": c, "n_rows": n_rows, "n_windows": spans,
            "n_empty": int((length == 0).sum()),
            "n_chunks": int(((length[long] + CHUNK - 1) // CHUNK).sum()),
            "n_long": int(long.sum())}


def launch_bytes(sizes: dict, per_row: bool) -> int:
    """Bytes one launch must move at least."""
    c, v = sizes["n_slots"], sizes["n_rows"]
    return (c * (4 + 1 + 4 + 4) + v * (4 + 4 + 4 + 4 * per_row)
            + 4 * (not per_row) + 4 * (sizes["n_windows"] + 1)
            + 4 * sizes["n_empty"] + 8 * sizes["n_chunks"]
            + 8 * sizes["n_long"])


def launch_ops(sizes: dict) -> int:
    """Float operations of one launch, about 12 a slot."""
    return 12 * sizes["n_slots"]
