"""The event-horizon leap on dynamic and networked lanes, on the CPU:
leap on == leap off, every leaf and every event count, over dynamic and
networked conformance scenarios (migration, failures, staged transfers;
enabled networked lanes never leap, the others do), and on
``bench_migration``'s threshold recipe, where windows open between
migrations."""
import pytest

from test_torch_dynamic_contracts import MAKE, _chip_smoke
from test_conformance import POLICY_GRID
from test_torch_state import assert_same_state

from repro_torch.core import state as S
from repro_torch.core.engine import run_stats

CPU = "cpu"
CASES = ([("dyn", s) for s in range(0, 16, 3)]
         + [("net", s) for s in range(8)])


@pytest.mark.parametrize("kind,seed", CASES)
def test_leap_on_equals_off_bitwise(kind, seed):
    for vp, tp in POLICY_GRID:
        dc = MAKE[kind](seed, vp, tp)
        off, s_off = run_stats(dc, max_steps=4096, leap=False)
        on, s_on = run_stats(dc, max_steps=4096, leap=True)
        assert_same_state(on, off, f"{kind} {seed} ({vp},{tp})")
        assert s_on.n_events == s_off.n_events == s_off.n_full


def test_leap_fires_on_the_migration_recipe_and_stays_bitwise():
    """bench_migration's threshold case (chip_smoke's recipe at its own
    size): the leap commits events in windows between migrations."""
    dc = _chip_smoke().migration_scenario(CPU, scale=1)
    off, s_off = run_stats(dc, max_steps=1 << 20, leap=False)
    on, s_on = run_stats(dc, max_steps=1 << 20, leap=True)
    assert_same_state(on, off)
    assert s_on.n_events == s_off.n_events
    assert s_on.n_full < s_off.n_full and s_on.n_leap > 0
    assert int(on.mig_count) == 51       # BENCH_policies.json's count
    assert bool((on.cloudlets.state == S.CL_DONE).all())
