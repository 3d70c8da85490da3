"""Each cell at a small size: the port on the CPU against the plain
reference, through the harness's own run (all but its look for a
card)."""
import pytest

from simbench_tiny import CELLS, run_tiny, tiny


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_port_agrees_with_reference(name, seed):
    out = run_tiny(name, seed)
    _, traffic = tiny(name)
    lanes = len(traffic["policy_grid"]) * traffic["seeds_per_call"]
    assert out["correct"], out["checks"]
    assert out["attempted"] == out["calls"] * lanes and out["failed"] == 0
    assert out["checks"]["events_gap"]["value"] == 0
    assert set(out["metrics"]) == {"scenarios_per_s", "setup_s"}
