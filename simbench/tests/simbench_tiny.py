"""Small sizes of the benchmark's cells for the CPU tests."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from simbench import harness  # noqa: E402

BENCH = harness.Bench(ROOT)
CELLS = [w["name"] for w in BENCH.spec["workloads"]]


def tiny(cell_name: str, n_hosts: int = 40, n_vms: int = 20,
         seeds_per_call: int = 2):
    """(config, traffic) of a cell with its datacenter and its calls cut
    to a size the CPU runs in a second; every other field as the cell's
    files have it."""
    cell = BENCH.cell(cell_name)
    config, traffic = BENCH.config(cell), BENCH.traffic(cell)
    config["hosts"]["count"] = n_hosts
    config["vms"]["count"] = n_vms
    traffic["seeds_per_call"] = seeds_per_call
    return config, traffic


def run_tiny(cell_name: str, seed: int, **kw) -> dict:
    """One CPU run of a cell at the small size: a warm-up call and one
    call in the window, then the comparison."""
    import time

    config, traffic = tiny(cell_name, **kw)
    return RUN.run_cell(ROOT, cell_name, seed, 0.0, False, "cpu",
                        config=config, traffic=traffic,
                        t_start=time.perf_counter())


def _load_run():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "simbench_run", ROOT / "simbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RUN = _load_run()
