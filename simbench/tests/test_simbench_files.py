"""Every configuration, cell, traffic mix and metric of BENCHMARK.json
is found by name and holds what the harness reads."""
import json

import pytest

from simbench_tiny import BENCH, CELLS, ROOT
from simbench import compare, harness

SPEC = BENCH.spec


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["simbench"]
    assert (ROOT / SPEC["command"][1]).is_file()


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert (ROOT / "simbench" / "drivers" / f"{data['kind']}.py").is_file()
    assert data["precision"] == "float32"


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    cell = BENCH.cell(name)
    BENCH.config(cell)
    traffic = BENCH.traffic(cell)
    assert traffic["seeds_per_call"] > 0 and traffic["policy_grid"]
    limits = BENCH.limits(cell)
    assert set(limits) == set(compare.NAMES)
    assert limits["mismatch"] == 0 and limits["events_gap"] == 0
    shown = [m["name"] for m in BENCH.metrics(cell, False)]
    assert "setup_s" in shown and len(shown) >= 2
    assert BENCH.metrics(cell, True)


@pytest.mark.parametrize(
    "metric", SPEC["end_to_end"] + SPEC["per_layer"],
    ids=lambda m: m["name"])
def test_metric_reader(metric):
    path = harness.ROOT / "metrics" / f"{metric['name']}.py"
    assert path.is_file()
    # a run with nothing to read gives no number, never 0
    empty = {"setup_s": 1.0, "window_s": 0.0, "items": 0, "calls": [],
             "peak_bytes": 0, "trace": None}
    value = harness.read_metric(metric["name"], empty)
    assert value is None or metric["name"] == "setup_s"
