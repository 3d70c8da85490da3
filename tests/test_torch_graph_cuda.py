"""The captured full step of ``engine._drive`` on the card: a static
block replayed as a CUDA graph against the same run with the graph
turned off (the private ``engine._graphable`` patched to refuse), on §5
at the paper's 10,000 hosts in two lanes (the two task policies).

Every test here needs the card (marker ``cuda``) and skips without one;
the file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_graph_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core import broker as B
from repro_torch.core import engine
from repro_torch.core import state as S
from repro_torch.core import sweep
from repro_torch.core.state import tensor_leaves
from repro_torch.kernels.simstep import simstep

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _section5(policy, device, late=0, jitter=None):
    """§5 at 10,000 hosts: 50 1-PE VMs, ten waves of 1.2M MI 600 s apart,
    PEs reserved; ``late`` more VMs submitted at t = 3,000 s (placed at a
    later boundary, so a second plan); ``jitter`` (a seed) stretches each
    task's length by up to 40%, so leap windows open between blocks."""
    specs = [B.VmSpec(count=50)]
    if late:
        specs.append(B.VmSpec(count=late, submit_time=3000.0))
    cl = B.build_waves(50 + late, B.WaveSpec(waves=10), device=device)
    if jitter is not None:
        rng = np.random.default_rng(jitter)
        f = torch.from_numpy((1.0 + 0.4 * rng.random(
            tuple(cl.length.shape))).astype(np.float32)).to(device)
        cl = dataclasses.replace(cl, length=cl.length * f,
                                 remaining=cl.remaining * f)
    return S.make_datacenter(
        S.make_uniform_hosts(10_000, idle_w=100.0, peak_w=200.0,
                             device=device),
        B.build_fleet(specs, device=device), cl,
        vm_policy=S.SPACE_SHARED, task_policy=policy, reserve_pes=True,
        rates=S.make_market(0.01, 0.001, 1e-4, 0.002, device=device),
        device=device)


KINDS = {"s5": {}, "late-vms": {"late": 10}, "jittered": {"jitter": 7}}


def _batch(kind, device):
    return sweep.stack_scenarios([_section5(p, device, **KINDS[kind])
                                  for p in (S.SPACE_SHARED, S.TIME_SHARED)])


def _run(batch, graph: bool, monkeypatch):
    """(final state, RunStats, simstep launches, recorded counters, peak
    bytes allocated) of one run, with the graph on or off."""
    with monkeypatch.context() as m:
        if not graph:
            m.setattr(engine, "_graphable", lambda *a: False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches = simstep.launches
        spans.take()
        with spans.recording():
            final, stats = engine.batched_run_stats(batch, max_steps=8192)
        torch.cuda.synchronize()
        rec = spans.take()
        peak = torch.cuda.max_memory_allocated()
        # on the host, so that the next run's peak does not hold it
        return (S.to_device(final, "cpu"), stats,
                simstep.launches - launches, rec["counters"], peak)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_graph_equals_eager_bitwise(cuda, kind, monkeypatch):
    """Every leaf of the final state and ``RunStats`` bit for bit, the
    same simstep launches, the input batch untouched, no more memory
    than the eager run's plus 1%, and one capture a plan."""
    batch = _batch(kind, cuda)
    before = [t.clone() for t in tensor_leaves(batch)]
    eager, s_eager, l_eager, c_eager, m_eager = _run(batch, False,
                                                     monkeypatch)
    got, s_got, l_got, c_got, m_got = _run(batch, True, monkeypatch)
    assert s_got == s_eager
    for a, b in zip(tensor_leaves(got), tensor_leaves(eager)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(tensor_leaves(batch),
                                                 before))
    assert l_got == l_eager == s_got.n_steps
    assert m_got <= 1.01 * m_eager, (m_got, m_eager)
    assert "graph.captures" not in c_eager
    captures = c_got["graph.captures"]
    assert c_got["graph.replays"] == s_got.n_steps - captures
    assert captures == {"s5": 1, "late-vms": 2}.get(kind, captures)
    assert 1 <= captures <= s_got.n_plans


def test_dropped_graphs_leave_no_memory_behind(cuda):
    """Each run drops its graphs; the next run's capture reuses the
    device's kept pool (``engine._kept``), so repeated runs stop adding
    to the memory the caching allocator reserves."""
    batch = _batch("s5", cuda)
    reserved = []
    for _ in range(6):
        engine.batched_run_stats(batch, max_steps=8192)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    assert reserved[-1] == reserved[2], reserved
