#!/usr/bin/env python3
"""Where a cell's host time goes, by the program's spans, on the card.

    python3 simbench/span_report.py --workload <name> --seed <n> \\
        [--seconds 10] [--pairs 40] [--calls 5] [--out <file>]

From the root of a checkout.  It runs the cell as ``run.py`` does (a
warm-up call, a window of ``--seconds``), then:

* ``--pairs`` pairs of calls, one unrecorded and one recorded
  (``record``: inside ``repro_torch.spans.recording()``, the spans kept
  in the call's record), alternating: the recorded calls give the span
  readers' metrics (``metrics``), the program's spans by self time, and
  ``recording_slowdown`` (a recorded call's mean wall over an
  unrecorded one's);
* ``--calls`` recorded calls under the profiler, as a traced run makes
  them: the device's idle gaps named by the harness's phases
  (``idle_harness``) and by the innermost program span
  (``idle_by_span``);
* four calls, unrecorded, recorded, recorded, unrecorded, under
  ``torch.cuda.set_sync_debug_mode("warn")``: the synchronising calls
  of each, and the program's in the recorded calls that no ``sync.*``
  span holds, by source line.

The first two stand in for a recorded-call stage of
``harness.closed_loop`` and span naming in ``harness.reduce_trace``,
which the benchmark lacks; the census has no such stage.  The last line
of standard output is one JSON object; ``--out`` writes it to a file as
well.  The answers are not checked (``run.py`` does).
"""
from __future__ import annotations

import argparse
import bisect
import importlib
import importlib.util
import json
import statistics
import sys
import time
import warnings
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
for p in (CHECKOUT, CHECKOUT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

METRICS = ("boundary_ms", "provision_ms", "step_host_ms", "syncs_per_step")


def wall(call: dict) -> float:
    return sum(call["spans"].values())


def record(driver, i: int) -> dict:
    """Driver call ``i`` recorded: its record with the spans and counters
    it recorded as ``program``."""
    from repro_torch import spans as recorder
    recorder.take()
    with recorder.recording():
        rec = driver.call(i, keep=False)
    rec["program"] = recorder.take()
    return rec


def recorded_pairs(driver, first: int, pairs: int) -> tuple[dict, dict]:
    """Alternate unrecorded and recorded calls: a run holding the recorded
    ones as ``recorded_calls``, and the walls compared."""
    off, on = [], []
    for k in range(pairs):
        for recording in ((False, True) if k % 2 == 0 else (True, False)):
            i = first + len(off) + len(on)
            if recording:
                on.append(record(driver, i))
            else:
                off.append(driver.call(i, keep=False))
    return {"recorded_calls": on}, {
        "recording_slowdown": (statistics.fmean(map(wall, on))
                               / statistics.fmean(map(wall, off))),
        "recorded_call_s": statistics.median(map(wall, on)),
        "unrecorded_call_s": statistics.median(map(wall, off))}


def report(run: dict) -> dict:
    """The span readers' metrics, and per span name [count, self ms] a
    recorded call (means) with the counters a call, of a run's recorded
    calls."""
    from simbench import harness, spans
    calls = run["recorded_calls"]
    n = len(calls)
    table = spans.self_ms([s for c in calls for s in c["program"]["spans"]])
    counters: dict[str, float] = {}
    for c in calls:
        for k, v in c["program"]["counters"].items():
            counters[k] = counters.get(k, 0) + v / n
    return {"metrics": {m: harness.read_metric(m, run) for m in METRICS},
            "program": {k: [c / n, ms / n] for k, (c, ms) in
                        sorted(table.items(), key=lambda kv: -kv[1][1])},
            "counters": counters}


def profiled(driver, n_calls: int) -> dict:
    """``n_calls`` recorded calls under the profiler, between marker
    kernels, as ``harness.closed_loop`` traces them."""
    import torch

    from simbench import harness, spans
    profile = lambda: torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    loop = harness.closed_loop(lambda i: record(driver, 10_000 + i), 0.0,
                               traced=n_calls, profile=profile)
    traced = [c for c in loop["calls"] if c["profiled"]]
    by_harness = harness.reduce_trace(loop["profiler"], loop["marks"],
                                      traced)
    by_span = harness.reduce_trace(
        loop["profiler"], loop["marks"],
        [{"phases": spans.flatten(c["phases"], c["program"]["spans"])}
         for c in traced])
    idle = by_span["window_s"] - by_span["busy_s"]
    bare = sum(t for n, t in by_span["idle_gaps"] if n in ("run", "build"))
    return {"profiled_call_s": statistics.median(map(wall, traced)),
            "n_ops": by_span["n_ops"], "busy_s": by_span["busy_s"],
            "window_s": by_span["window_s"], "idle_s": idle,
            "idle_harness": by_harness["idle_gaps"],
            "idle_by_span": by_span["idle_gaps"],
            "idle_bare_run_build_share": bare / idle if idle > 0 else None,
            "launches_per_step": by_span["n_ops"] / sum(
                map(spans.steps, traced))}


def sync_census(driver) -> dict:
    """Synchronising calls of calls unrecorded and recorded (off, on, on,
    off); of the recorded ones, which span holds each, and the
    program's that no ``sync.*`` span holds, by source line."""
    import torch

    from simbench import spans

    def one(index, recording):
        seen = []

        def hook(message, category, filename, lineno, *rest):
            if "synchroniz" in str(message):
                seen.append((time.perf_counter(), f"{filename}:{lineno}"))

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rec = (record(driver, index) if recording
                       else driver.call(index, keep=False))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return rec, seen

    counts = {False: [], True: []}
    held: dict[str, int] = {}
    outside: dict[str, int] = {}
    n_sync_spans = []
    for k, recording in enumerate((False, True, True, False)):
        rec, seen = one(20_000 + k, recording)
        counts[recording].append(len(seen))
        if not recording:
            continue
        got = rec["program"]["spans"]
        n_sync_spans.append(sum(1 for s in got if s[0].startswith("sync.")))
        flat = spans.flatten(rec["phases"], got)
        starts = [a for _, a, _ in flat]
        for t, where in seen:
            j = bisect.bisect_right(starts, t) - 1
            name = flat[j][0] if j >= 0 and t < flat[j][2] else "none"
            held[name] = held.get(name, 0) + 1
            if not name.startswith("sync.") and "simbench" not in where:
                site = f"{name} {where}"
                outside[site] = outside.get(site, 0) + 1
    return {"off": counts[False], "on": counts[True],
            "sync_spans": n_sync_spans, "held_by": dict(sorted(held.items())),
            "program_outside_sync_spans": dict(sorted(outside.items()))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--pairs", type=int, default=40)
    p.add_argument("--calls", type=int, default=5)
    p.add_argument("--out")
    args = p.parse_args(argv)
    spec = importlib.util.spec_from_file_location(
        "simbench_run", CHECKOUT / "simbench" / "run.py")
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    runner.cache_dirs(CHECKOUT)
    import torch

    from simbench import harness
    if not torch.cuda.is_available():
        print("span_report: no CUDA device", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    bench = harness.Bench(CHECKOUT)
    cell = bench.cell(args.workload)
    config = bench.config(cell)
    drivers = importlib.import_module(f"simbench.drivers.{config['kind']}")
    driver = drivers.Driver(config, bench.traffic(cell), args.seed, "cuda:0")
    driver.call(0, keep=False)
    window = harness.closed_loop(lambda i: driver.call(i, keep=False),
                                 args.seconds)["calls"]
    run, walls = recorded_pairs(driver, len(window) + 1, args.pairs)
    prof = profiled(driver, args.calls)
    prof["profiler_slowdown"] = (prof["profiled_call_s"]
                                 / walls["unrecorded_call_s"])
    out = {"workload": args.workload, "seed": args.seed,
           "card": runner.card_line(),
           "window_calls": len(window),
           "window_call_s": statistics.median(map(wall, window)),
           "ms_per_step_window": 1e3 * sum(c["spans"]["run"] for c in window)
           / sum(c["counters"]["n_steps"] + c["counters"]["n_leap"]
                 for c in window),
           **walls, **report(run), **prof, "syncs": sync_census(driver)}
    line = json.dumps(out, allow_nan=False)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
