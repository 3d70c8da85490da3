"""What every cell shares: finding its files by name, the closed loop of
calls, the profiler's trace reduced to device intervals, and the
metric readers.

A metric's reader is ``metrics/<name>.py`` with one function,
``read(run) -> float | None``; ``run`` is the dict ``run_cell`` builds
(set-up and window seconds, the calls' spans and counts, the trace, and
with a trace what the driver's ``trace_inputs()`` gives).  A
reader that finds nothing to read returns None and the metric is left
out of the result.
"""
from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import time
from pathlib import Path

__all__ = ["ROOT", "Bench", "closed_loop", "reduce_trace", "read_metric"]

ROOT = Path(__file__).resolve().parent


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == cell["config"]:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell: dict) -> dict:
        return _json(ROOT / "traffic" / f"{cell['traffic']}.json")

    def limits(self, cell: dict) -> dict:
        return _json(ROOT / "workloads" / f"{cell['name']}.json")["limits"]

    def metrics(self, cell: dict, trace: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: its end-to-end metrics,
        or with ``trace`` its per-layer ones."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if cell["name"] in m.get("workloads", [cell["name"]])]


def _json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def _mark(torch) -> float:
    """A tiny spin kernel on the card, run at once: it marks the host
    clock's now on the device's timeline.  Returns the host time."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(1)
    torch.cuda.synchronize()
    return t


MARKER = "spin_kernel"      # the kernel ``torch.cuda._sleep`` launches


def closed_loop(call, seconds: float, traced: int = 0,
                profile=None) -> dict:
    """Issue ``call(i)`` for i = 1, 2, ... (0 is the warm-up) until
    ``seconds`` have passed, each when the last returns; then ``traced``
    more calls inside ``profile()``, between two marker kernels.  They
    come after the window because the profiler, once started, slows
    every later launch of the process.  Returns the calls' records (each
    with the seconds Python's garbage collector took inside it, ``gc_s``,
    the process's CPU seconds, ``cpu_s``, and whether it was
    ``profiled``), the lanes the window's calls ran, the window's
    seconds, less what its calls left out (``excluded_s``), and the
    profiler with the host times of its markers."""
    calls, marks = [], []
    gc_s, gc_t0 = [0.0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_t0[0]

    def issue(i, profiled):
        before, cpu = gc_s[0], time.process_time()
        rec = call(i)
        rec["gc_s"] = gc_s[0] - before
        rec["cpu_s"] = time.process_time() - cpu
        rec["profiled"] = profiled
        calls.append(rec)

    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or not calls:
        issue(len(calls) + 1, False)
    window = time.perf_counter() - t0 - sum(c.get("excluded_s", 0.0)
                                            for c in calls)
    items = sum(c["items"] for c in calls)
    prof = None
    if traced:
        import torch
        prof = profile()
        prof.__enter__()
        marks.append(_mark(torch))
        for _ in range(traced):
            issue(len(calls) + 1, True)
        marks.append(_mark(torch))
        prof.__exit__(None, None, None)
    gc.callbacks.remove(on_gc)
    return {"calls": calls, "items": items, "window_s": window,
            "profiler": prof, "marks": marks}


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")()
                                              * 1000)


def reduce_trace(prof, marks, calls) -> dict | None:
    """The profiler's device record reduced.  The window runs from the
    first marker kernel's start to the last one's end; the device is busy
    where a kernel, copy or set runs (the union of their intervals); the
    device operations are summed by name; each idle gap is named by the
    host phase of the profiled calls (``calls[i]["phases"]``, host-clock
    intervals) that holds its middle, the host clock put on the device's
    by the first marker.  None when the trace holds no device operation
    besides the markers."""
    from torch.autograd import DeviceType
    dev, spin = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        (spin if MARKER in e.name() else dev).append((start, end, e.name()))
    if not dev or len(spin) < 2:
        return None
    spin.sort()
    lo, hi = spin[0][0], spin[-1][1]
    offset = lo - round(marks[0] * 1e9)     # device ns - host ns
    dev = sorted(d for d in dev if d[1] > lo and d[0] < hi)
    by_name: dict[str, list] = {}
    busy, gaps, cur_s, cur_e = 0, [], lo, lo
    for s, e, name in dev:
        slot = by_name.setdefault(name, [0, 0])
        slot[0] += 1
        slot[1] += e - s
        s, e = max(s, lo), min(e, hi)
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s = s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if hi > cur_e:
        gaps.append((cur_e, hi))
    phases = sorted((round(a * 1e9) + offset, round(b * 1e9) + offset, n)
                    for c in calls for n, a, b in c.get("phases", ()))
    starts = [a for a, _, _ in phases]
    idle: dict[str, int] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        k = bisect.bisect_right(starts, mid) - 1
        name = (phases[k][2] if k >= 0 and mid < phases[k][1]
                else "between calls")
        idle[name] = idle.get(name, 0) + (b - a)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9,
            "ops": {n: (c, t / 1e9) for n, (c, t) in by_name.items()},
            "n_ops": len(dev),
            "device_ops": [[n, t / 1e9] for n, t in
                           top({n: t for n, (_, t) in by_name.items()})],
            "idle_gaps": [[n, t / 1e9] for n, t in top(idle)]}


def read_metric(name: str, run: dict):
    """``metrics/<name>.py``'s ``read(run)``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"simbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)
