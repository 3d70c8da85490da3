"""The result line's form: one JSON object with the contract's keys,
strict JSON (no NaN), shallow, and a few kilobytes whatever the number
of calls in the window."""
import json

import pytest

from simbench_tiny import CELLS, RUN, run_tiny

LINE_BYTES = 8192


def _depth(x) -> int:
    if isinstance(x, dict):
        return 1 + max(map(_depth, x.values()), default=0)
    if isinstance(x, list):
        return 1 + max(map(_depth, x), default=0)
    return 0


@pytest.mark.parametrize("name", CELLS)
def test_result_line_is_one_small_json_object(name):
    out = run_tiny(name, 2**31 + 41)
    line = json.dumps(out, allow_nan=False)
    back = json.loads(line)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(back)
    assert list(back)[-1] == "checks"
    assert _depth(back) <= 4 and len(line) < LINE_BYTES
    assert back["window"]["counters"]["n_steps"] > 0


def test_window_sums_do_not_grow_with_calls():
    call = {"spans": {"build": 0.01, "run": 0.15, "summary": 0.001},
            "gc_s": 0.0, "cpu_s": 0.16, "profiled": False,
            "counters": {"n_steps": 24, "n_leap": 0, "n_events": 34}}
    few = RUN.window_sums([dict(call)] * 3)
    many = RUN.window_sums([dict(call)] * 3000 + [{**call, "profiled": True}])
    assert len(json.dumps(many)) < len(json.dumps(few)) + 64
    assert many["counters"]["n_steps"] == 24 * 3000
    assert many["call_s"]["min"] == many["call_s"]["max"]
