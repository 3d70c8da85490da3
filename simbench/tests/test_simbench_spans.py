"""The program's spans as the benchmark reads them (``simbench/spans.py``,
the readers ``boundary_ms``, ``provision_ms``, ``step_host_ms``,
``syncs_per_step`` and ``span_report.py``'s recorded calls): recorded
calls report the four metrics, the other readers read the same with them
present as without, each recorded call keeps its own spans, profiled or
not, and the device's idle gaps are named by the innermost span."""
import importlib
import importlib.util
import json
import time

import pytest
import torch

from simbench_tiny import CELLS, ROOT, RUN, tiny
from test_simbench_line import LINE_BYTES, _depth
from simbench import harness, spans

NEW = ("boundary_ms", "provision_ms", "step_host_ms", "syncs_per_step")


def _span_report():
    spec = importlib.util.spec_from_file_location(
        "simbench_span_report", ROOT / "simbench" / "span_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REPORT = _span_report()


def _driver(name, seed):
    config, traffic = tiny(name)
    driver = importlib.import_module(
        f"simbench.drivers.{config['kind']}").Driver(
            config, traffic, seed, torch.device("cpu"))
    driver.call(0, keep=False)
    return driver


def _window(driver):
    loop = harness.closed_loop(lambda i: driver.call(i, keep=False), 0.0)
    return {"setup_s": 1.0, "window_s": loop["window_s"],
            "items": loop["items"], "calls": loop["calls"],
            "peak_bytes": 0, "trace": None}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_with_recorded_calls_reports_the_span_metrics(name):
    driver = _driver(name, 2**31 + 907)
    run = _window(driver)
    recorded, walls = REPORT.recorded_pairs(driver, len(run["calls"]) + 1,
                                            2)
    run.update(recorded)
    assert len(run["recorded_calls"]) == 2 and walls["recording_slowdown"] > 0
    got = {k: harness.read_metric(k, run) for k in NEW}
    assert got["syncs_per_step"] > 0
    assert got["boundary_ms"] >= got["provision_ms"] > 0
    assert got["step_host_ms"] > 0
    out = REPORT.report(run)
    assert out["metrics"] == got
    assert out["counters"]["provision.lanes"] > 0
    assert out["program"]["step.full"][0] == pytest.approx(
        sum(map(spans.steps, run["recorded_calls"])) / 2)
    line = json.dumps({**walls, **out}, allow_nan=False)
    assert _depth(json.loads(line)) <= 4 and len(line) < LINE_BYTES
    # a traced run of the benchmark neither reports nor asks for the four
    # (the harness makes no recorded calls)
    config, traffic = tiny(name)
    traced = RUN.run_cell(ROOT, name, 2**31 + 907, 0.0, True, "cpu",
                          config=config, traffic=traffic,
                          t_start=time.perf_counter())
    assert not set(NEW) & (set(traced["metrics"]) | set(traced["missing"]))


def test_the_other_readers_read_the_same_with_spans_present():
    driver = _driver(CELLS[0], 2**31 + 5)
    run = _window(driver)
    spec = harness.Bench(ROOT).spec
    old = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert not set(NEW) & set(old)
    before = {m: harness.read_metric(m, run) for m in old}
    assert {m: harness.read_metric(m, run) for m in NEW} == dict.fromkeys(NEW)
    run["recorded_calls"] = [REPORT.record(driver, 100)]
    new = {m: harness.read_metric(m, run) for m in NEW}
    assert None not in new.values()
    assert {m: harness.read_metric(m, run) for m in old} == before
    assert before["ms_per_step"] is not None


@pytest.mark.parametrize("name", NEW)
def test_span_reader_gives_nothing_without_recorded_calls(name):
    """A run as the harness makes it today (window calls, no recorded
    ones), or with a recorded call that ran no loop, gives no number and
    does not raise."""
    window = {"phases": [("build", 0.0, 1.0), ("run", 1.0, 2.0)],
              "counters": {"n_steps": 24, "n_leap": 0}}
    empty = {"setup_s": 1.0, "window_s": 0.0, "items": 0, "calls": [],
             "peak_bytes": 0, "trace": None}
    for run in (empty, {**empty, "calls": [window]},
                {**empty, "recorded_calls": []},
                {**empty, "recorded_calls": [{
                    **window, "counters": {"n_steps": 0, "n_leap": 0},
                    "program": {"spans": [], "counters": {}}}]}):
        assert harness.read_metric(name, run) is None


def test_recorded_spans_belong_to_the_calls_that_hold_them():
    call = lambda steps, program: {
        "counters": {"n_steps": steps, "n_leap": 0},
        "program": {"counters": {}, "spans": program}}
    run = {"recorded_calls": [
        call(4, [("sync.passes.probes", 10.9, 10.95, -1),
                 ("drive", 11.0, 13.0, -1),
                 ("drive.read", 11.0, 11.5, 1),
                 ("sync.drive.read", 11.2, 11.3, 2),
                 ("step.full", 11.5, 12.0, 1),
                 ("sync.index.bincount", 11.6, 11.7, 4)]),
        call(6, [("drive", 21.0, 25.0, -1),
                 ("drive.boundary", 21.0, 22.0, 0),
                 ("drive.provision", 21.0, 21.5, 1),
                 ("step.full", 22.0, 24.0, 0)]),
        call(8, [("run.summary", 30.0, 31.0, -1)])]}    # no drive: skipped
    assert spans.recorded(run) == run["recorded_calls"][:2]
    assert spans.recorded({"calls": []}) == []
    read = lambda m: harness.read_metric(m, run)
    assert read("boundary_ms") == pytest.approx((500.0 + 1000.0) / 2)
    assert read("provision_ms") == pytest.approx(500.0 / 2)
    assert read("step_host_ms") == pytest.approx((500.0 + 2000.0) / 10)
    assert read("syncs_per_step") == pytest.approx(2 / 10)
    assert spans.self_ms(run["recorded_calls"][1]["program"]["spans"])[
        "drive.boundary"] == pytest.approx([1, 500.0])


def test_profiled_recorded_calls_keep_their_own_spans(monkeypatch):
    """``span_report``'s traced stage on the CPU (a CPU profile, the
    marker kernels stubbed): each profiled call records inside its own
    phases, and its spans and phases flatten into disjoint pieces."""
    driver = _driver(CELLS[1], 2**31 + 77)
    monkeypatch.setattr(harness, "_mark", lambda torch: time.perf_counter())
    profile = lambda: torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    loop = harness.closed_loop(lambda i: REPORT.record(driver, i), 0.0,
                               traced=2, profile=profile)
    traced = [c for c in loop["calls"] if c["profiled"]]
    assert len(traced) == 2
    for c in traced:
        got = c["program"]["spans"]
        lo, hi = c["phases"][0][1], c["phases"][-1][2]
        assert got and all(lo <= a <= b <= hi for _, a, b, _ in got)
        assert sum(1 for s in got if s[0] == "step.full") == spans.steps(c)
        flat = spans.flatten(c["phases"], got)
        assert all(a < b <= a2 for (_, a, b), (_, a2, _) in
                   zip(flat, flat[1:]))
        assert {"drive.read", "step.full"} <= {n for n, _, _ in flat}


class _Event:
    """A device operation as the profiler's kineto results give it."""

    def __init__(self, name, start_s, end_s):
        self._name, self._s, self._e = name, start_s, end_s

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA

    def name(self):
        return self._name

    def start_ns(self):
        return round(self._s * 1e9)

    def duration_ns(self):
        return round(self._e * 1e9) - round(self._s * 1e9)


class _Profile:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_idle_gaps_are_named_by_the_innermost_span():
    ms = lambda x: 1.0 + x * 1e-3           # host seconds
    prof = _Profile([_Event(harness.MARKER, ms(0), ms(0.001)),
                     _Event("k1", ms(3.0), ms(4.0)),
                     _Event("k2", ms(5.6), ms(6.0)),
                     _Event("k3", ms(11.5), ms(12.0)),
                     _Event(harness.MARKER, ms(13.0), ms(13.001))])
    phases = [("build", ms(0.1), ms(2.0)), ("run", ms(2.0), ms(10.0)),
              ("summary", ms(10.0), ms(11.0))]
    program = [("drive", ms(3.0), ms(9.0), -1),
               ("drive.boundary", ms(4.0), ms(6.0), 0),
               ("drive.provision", ms(4.5), ms(5.5), 1)]
    by_phase = harness.reduce_trace(prof, [ms(0)], [{"phases": phases}])
    flat = spans.flatten(phases, program)
    by_span = harness.reduce_trace(prof, [ms(0)], [{"phases": flat}])
    names = lambda tr: {n for n, _ in tr["idle_gaps"]}
    assert names(by_phase) == {"build", "run", "between calls"}
    assert names(by_span) == {"build", "drive.provision", "drive",
                              "between calls"}
    for key in ("busy_s", "n_ops", "ops", "window_s"):
        assert by_span[key] == by_phase[key]


def test_flatten_names_each_piece_by_its_innermost_interval():
    flat = spans.flatten(
        [("run", 0.0, 10.0), ("summary", 10.0, 12.0)],
        [("drive", 1.0, 9.0, -1), ("drive.read", 1.0, 2.0, 0),
         ("drive.steps", 3.0, 8.0, 0), ("step.full", 3.0, 4.0, 2),
         ("step.full", 4.0, 5.0, 2), ("run.summary", 10.5, 12.5, -1)])
    assert flat == [("run", 0.0, 1.0), ("drive.read", 1.0, 2.0),
                    ("drive", 2.0, 3.0), ("step.full", 3.0, 4.0),
                    ("step.full", 4.0, 5.0), ("drive.steps", 5.0, 8.0),
                    ("drive", 8.0, 9.0), ("run", 9.0, 10.0),
                    ("summary", 10.0, 10.5), ("run.summary", 10.5, 12.0)]
