"""Conformance of the port's networked path: the 32 networked scenarios
of ``tests/test_conformance.py`` (8 ``NET_SEEDS`` x the 2x2 policy grid:
random two-tier topologies, staged transfers with some zero sizes, and
on odd seeds host failures with THRESHOLD or DRAIN migration routed over
the topology), each run by ``repro_torch.core.engine.run_stats`` on the
CPU and held against the f64 oracle and the JAX engine exactly as the
dynamic scenarios are (``test_torch_dynamic_conformance``).
"""
import pytest

from test_conformance import (NET_SEEDS, POLICY_GRID,
                              make_networked_scenario)
from test_torch_dynamic_conformance import conform

from repro.oracle import simulate_dense
from repro_torch.core import state as S

CASES = [(seed, vp, tp) for seed in NET_SEEDS for vp, tp in POLICY_GRID]


@pytest.mark.parametrize("seed,vp,tp", CASES)
def test_networked_scenario_conforms(seed, vp, tp):
    out = conform(make_networked_scenario(seed, vp, tp), (seed, vp, tp))
    # byte conservation: the MB booked are the inputs and outputs of the
    # DONE cloudlets and the inputs of those that staged in but never
    # finished (their VM failed), within 1e-3 MB
    cl = out.cloudlets
    done = (cl.state == S.CL_DONE).numpy()
    staged_in = ((cl.net_phase == S.NET_RUN)
                 | (cl.net_phase == S.NET_STAGE_OUT)).numpy() & ~done
    f64 = lambda t: t.double().numpy()
    want = (f64(cl.file_size + cl.output_size)[done].sum()
            + f64(cl.file_size)[staged_in].sum())
    assert abs(float(out.net_transferred_mb) - want) <= 1e-3, (seed, vp, tp)


@pytest.mark.parametrize("vp,tp", POLICY_GRID)
def test_networked_scenarios_move_bytes(vp, tp):
    """Each policy row of the 32 stages data (the oracle's MB, which the
    port matches within 1e-3 above)."""
    total = sum(simulate_dense(make_networked_scenario(seed, vp, tp))
                .transferred_mb for seed in NET_SEEDS)
    assert total > 0.0
