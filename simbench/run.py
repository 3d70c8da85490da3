#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the CUDA card.

    python3 simbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  It puts the checkout's ``src`` on the
path, keeps every build cache inside the checkout (the kernels in
``build/kernels/``), makes the cell's scenarios from the seed, runs one
warm-up call at the cell's shapes (set-up ends there), then issues calls
for ``--seconds``.  With ``--trace 1`` a few more calls run under the
profiler after the window and the result carries the cell's per-layer
metrics; with ``--trace 0`` its end-to-end ones.  After the window the kept
answers are compared with the plain reference, on the card, and the last
line of standard output is the result:

    {"correct": ..., "attempted": ..., "failed": ..., "metrics": {...},
     "device": {...}, ..., "checks": {...}}

``attempted`` counts the lanes compared and ``failed`` those with an
unequal exact answer.  Between ``device`` and ``checks`` it also gives
what the next reader of a run needs: the metrics no reader found
(``missing``), the window's calls and seconds, its calls' spans and
counts summed (``window``), the warm-up call's and the check's seconds,
with a trace how much the profiler slowed a call
(``profiler_slowdown``), and the card's name and power limit.  The line
stays a few kilobytes however many calls the window holds.

The compared numbers, each beside its limit, are also the last lines of
standard error.  Without a card, with fewer cards than the cell asks
for, or with JAX or the JAX package loaded once the window has closed,
it prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
CHECKOUT = Path(__file__).resolve().parents[1]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))
sys.path.insert(0, str(CHECKOUT / "src"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is
    JAX's, Flax's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / sub)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out[0] if out else "nvidia-smi printed nothing"


def profiler_slowdown(calls) -> float | None:
    """A profiled call's mean wall over a window call's (the window runs
    before the profiler starts)."""
    mean = lambda cs: sum(sum(c["spans"].values()) for c in cs) / len(cs)
    traced = [c for c in calls if c["profiled"]]
    rest = [c for c in calls if not c["profiled"]]
    return mean(traced) / mean(rest) if traced and rest else None


def window_sums(calls) -> dict:
    """The window's calls summed (the profiled ones left out): their spans,
    garbage collection and CPU seconds and their counts, with the least,
    median and largest call.  A few hundred calls, one line each, would
    not fit the result line."""
    calls = [c for c in calls if not c["profiled"]]
    walls = sorted(sum(c["spans"].values()) for c in calls)
    total = lambda key: {k: sum(c[key][k] for c in calls)
                         for k in calls[0][key]} if calls else {}
    return {"spans_s": total("spans"), "counters": total("counters"),
            "gc_s": sum(c["gc_s"] for c in calls),
            "cpu_s": sum(c["cpu_s"] for c in calls),
            "call_s": {"min": walls[0], "median": walls[len(walls) // 2],
                       "max": walls[-1]} if walls else {}}


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, *, config=None, traffic=None,
             t_start: float | None = None) -> dict:
    """One run of a cell on ``device``; returns the result line's fields
    (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
    ``checks``) and ``breakdown`` when traced.  ``config`` and
    ``traffic`` replace the cell's files (the CPU tests' small sizes)."""
    import importlib

    import torch

    from simbench import harness

    bench = harness.Bench(root)
    cell = bench.cell(workload)
    config = bench.config(cell) if config is None else config
    traffic = bench.traffic(cell) if traffic is None else traffic
    limits = bench.limits(cell)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    drivers = importlib.import_module(f"simbench.drivers.{config['kind']}")
    driver = drivers.Driver(config, traffic, seed, dev)

    t_warm = time.perf_counter()
    driver.call(0, keep=False)                  # warm-up at the cell's shapes
    t_warm = time.perf_counter() - t_warm
    warm_peak = 0
    if cuda:
        torch.cuda.synchronize(dev)
        warm_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - (T_START if t_start is None
                                     else t_start)
    traced = int(traffic["trace_calls"]) if trace and cuda else 0
    profile = lambda: torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    loop = harness.closed_loop(driver.call, seconds, traced=traced,
                               profile=profile)
    peak = 0
    if cuda:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    run = {"setup_s": setup_s, "window_s": loop["window_s"],
           "items": loop["items"], "calls": loop["calls"],
           "peak_bytes": peak, "trace": None}
    if traced:
        run["trace"] = harness.reduce_trace(
            loop["profiler"], loop["marks"],
            [c for c in loop["calls"] if c["profiled"]])
        run.update(driver.trace_inputs())
    del loop
    names = [m["name"] for m in bench.metrics(cell, trace)]
    metrics = {}
    for m in bench.metrics(cell, trace):
        value = harness.read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t_check = time.perf_counter()
    checker = driver.check()
    ok, checks = checker.verdict(limits)
    t_check = time.perf_counter() - t_check
    out = {"correct": ok, "attempted": checker.lanes,
           "failed": checker.failed_lanes, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else dev.type,
                      "kind": (torch.cuda.get_device_name(dev) if cuda
                               else dev.type),
                      "count": 1,
                      "memory_peak_bytes": max(peak, warm_peak)},
           "missing": [n for n in names if n not in metrics],
           "calls": len(run["calls"]), "window_s": run["window_s"],
           "warmup_s": t_warm, "check_s": t_check,
           "window": window_sums(run["calls"])}
    if run["trace"] is not None:
        out["profiler_slowdown"] = profiler_slowdown(run["calls"])
        out["device"]["busy_s"] = run["trace"]["busy_s"]
        out["device"]["window_s"] = run["trace"]["window_s"]
        out["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                            "idle_gaps": run["trace"]["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs(CHECKOUT)
    import torch
    from simbench import harness
    cell = harness.Bench(CHECKOUT).cell(args.workload)
    need = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"simbench: the cell needs {need} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    torch.set_num_threads(1)        # one process, one host thread
    out = run_cell(CHECKOUT, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"simbench: loaded after the window: {bad}", file=sys.stderr)
        return 4
    out = {**{k: v for k, v in out.items() if k != "checks"},
           "card": card_line(), "checks": out["checks"]}
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
