"""Conformance of the port's elastic path, time-shared task policy: the
other half of ``test_torch_elastic_conformance.py`` (the same checks on
the same ``ELASTIC_SEEDS`` and ``ELASTIC_STREAM_SEEDS`` scenarios)."""
import pytest

from test_conformance import ELASTIC_SEEDS, ELASTIC_STREAM_SEEDS
from test_torch_elastic_conformance import conform_dense, conform_stream

from repro.oracle import simulate_dense
from test_conformance import make_elastic_scenario
from repro_torch.core import state as S

TASK_POLICY = S.TIME_SHARED


@pytest.mark.parametrize("vp", [S.SPACE_SHARED, S.TIME_SHARED])
@pytest.mark.parametrize("seed", ELASTIC_SEEDS)
def test_elastic_scenario_conforms(seed, vp):
    conform_dense(seed, vp, TASK_POLICY)


@pytest.mark.parametrize("vp", [S.SPACE_SHARED, S.TIME_SHARED])
@pytest.mark.parametrize("seed", ELASTIC_STREAM_SEEDS)
def test_elastic_streamed_scenario_conforms(seed, vp):
    conform_stream(seed, vp, TASK_POLICY)


def test_elastic_scenarios_exercise_the_loop():
    """Both directions and the spot track under this task policy."""
    ups = downs = 0
    spot = 0.0
    for seed in ELASTIC_SEEDS:
        for vp in (S.SPACE_SHARED, S.TIME_SHARED):
            res = simulate_dense(make_elastic_scenario(seed, vp,
                                                       TASK_POLICY))
            ups += res.scale_up_count
            downs += res.scale_down_count
            spot += res.spot_cost
    assert ups > 0 and downs > 0 and spot > 0.0
