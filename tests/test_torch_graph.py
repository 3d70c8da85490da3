"""The captured full step of ``engine._drive`` (``_StepGraph``), on the CPU.

A CUDA graph needs the card (``tests/test_torch_graph_cuda.py``); here
the decision to capture is held to its conditions, a CPU run is shown to
capture nothing, the in-place form of a full step (what a capture
records) is held bitwise to the eager form, and the drive loop's
bookkeeping around a capture (when to capture, when a capture still
fits, the carries copied into its buffers) runs with the capture
replaced by a CPU stand-in that replays by calling the step again.
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core import broker as B
from repro_torch.core import engine
from repro_torch.core import state as S
from repro_torch.core import sweep
from repro_torch.core.provisioning import FIRST_FIT
from repro_torch.core.scheduling import host_plan, lanes_of
from repro_torch.core.state import tensor_leaves, with_leaves

CPU = "cpu"
STATIC = engine._STATIC


def _section5(seed, late=0, events=None):
    """§5 at a tiny size; ``late`` more VMs are submitted at t = 1500 s
    and are provisioned at a later block boundary."""
    hosts = S.make_uniform_hosts(12, device=CPU)
    specs = [B.VmSpec(count=4, pes=1, mips=1000.0, ram=512.0, bw=10.0,
                      size=1000.0)]
    if late:
        specs.append(B.VmSpec(count=late, submit_time=1500.0))
    vms = B.build_fleet(specs, device=CPU)
    cl = B.build_waves(4 + late, B.WaveSpec(waves=3), device=CPU)
    return S.make_datacenter(hosts, vms, cl, task_policy=seed % 2,
                             events=events, device=CPU)


def _staggered(seed):
    """Reserved PEs and jittered lengths: leap windows open, so blocks of
    full steps and of leap iterations alternate on one plan."""
    rng = np.random.default_rng(seed)
    hosts = S.make_uniform_hosts(8, pes=2, ram=2048.0, device=CPU)
    vms = B.build_fleet([B.VmSpec(count=6)], device=CPU)
    cl = B.build_waves(6, B.WaveSpec(waves=3, length_mi=600_000.0,
                                     period=300.0), device=CPU)
    jit = torch.from_numpy(
        (1.0 + 0.4 * rng.random(tuple(cl.length.shape))).astype(np.float32))
    cl = dataclasses.replace(cl, length=cl.length * jit,
                             remaining=cl.remaining * jit)
    return S.make_datacenter(hosts, vms, cl, task_policy=S.TIME_SHARED,
                             reserve_pes=True, device=CPU)


def _events(seed):
    """Due event rows, then VMs placed at a later boundary: dynamic
    blocks (eager) before a static one."""
    return _section5(seed, late=2, events=S.make_events(
        [100.0 + 50.0 * seed, 300.0, 200.0],
        [S.EV_HOST_FAIL, S.EV_HOST_RECOVER, S.EV_VM_DESTROY], [0, 0, 3],
        device=CPU))


MAKE = {"section5": _section5, "late-vms": lambda s: _section5(s, late=2),
        "staggered": _staggered, "events": _events}


def _batch(kind):
    return sweep.stack_scenarios([MAKE[kind](seed) for seed in (0, 1)])


def _equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tensor_leaves(a), tensor_leaves(b)))


@pytest.mark.parametrize("device,stream,bp,leap,expected", [
    ("cuda", None, STATIC, True, True),
    ("cuda", None, STATIC, False, True),
    ("cpu", None, STATIC, True, False),
    ("cuda", "stream", STATIC, True, False),
    ("cuda", None, STATIC._replace(dynamic=True), True, False),
    ("cuda", None, STATIC._replace(dynamic=True, migration=True), True,
     False),
    ("cuda", None, STATIC._replace(network=True), True, False),
    ("cuda", None, STATIC._replace(elastic=True), True, False),
    ("cuda", None, STATIC._replace(probed=True), True, False),
], ids=["cuda-static-leap", "cuda-static-noleap", "cpu", "stream",
        "dynamic", "migration", "network", "elastic", "probed"])
def test_graph_engages_only_where_capture_is_safe(device, stream, bp, leap,
                                                  expected):
    """The device, the stream and the block's passes decide; the leap
    flag does not (the leap body is not in a block of full steps)."""
    stream = object() if stream else None
    assert engine._graphable(torch.device(device), stream, bp) is expected


def test_cpu_run_records_no_capture():
    spans.take()
    with spans.recording():
        engine.batched_run_stats(_batch("section5"), max_steps=4096)
    rec = spans.take()
    names = collections.Counter(s[0] for s in rec["spans"])
    assert names["drive.capture"] == 0 and names["step.full"] > 0
    assert not [k for k in rec["counters"] if k.startswith("graph.")]


@pytest.mark.parametrize("leap", [True, False], ids=["leap", "noleap"])
def test_inplace_step_equals_eager_step(leap):
    """``_advance`` with ``inplace`` (the form a capture records) writes
    the eager form's bits into its carry's own tensors, and nothing
    else."""
    batch = _batch("staggered")
    lanes = lanes_of(batch)
    batch = engine._provision_lanes(batch, [0, 1], FIRST_FIT)
    plan = host_plan(batch, lanes)
    nb = lanes.n_lanes
    c = engine._Carry(
        batch, torch.zeros(nb, dtype=torch.int32),
        torch.zeros(nb, dtype=torch.int32), torch.zeros(nb, dtype=torch.int32),
        torch.ones(nb, dtype=torch.bool), torch.zeros(nb, dtype=torch.bool),
        torch.zeros(batch.cloudlets.remaining.shape),
        torch.zeros(nb * lanes.n_vms, dtype=torch.int32),
        torch.zeros(nb, dtype=torch.bool), torch.zeros(nb, dtype=torch.bool),
        torch.zeros(nb, dtype=torch.bool), None)
    hor = torch.tensor(float("inf"))
    kw = dict(leap=leap, max_steps=4096, hor=hor)
    for _ in range(6):
        go = engine._gate(c, c.alive & (c.n < 4096), STATIC)
        eager = engine._advance(c, go, lanes, plan, STATIC, **kw)
        own = c._replace(batch=with_leaves(c.batch, [
            t.clone() for t in tensor_leaves(c.batch)]), **{
            f: getattr(c, f).clone() for f in
            ("n", "n_full", "used", "alive", "window", "r0", "n_now")})
        bufs = engine._buffers(own)
        kept = [t.clone() for t in engine._reads(own.batch) if t is not None]
        out = engine._advance(own, go, lanes, plan, STATIC, inplace=True,
                              **kw)
        assert [t.data_ptr() for t in engine._buffers(out)] == [
            t.data_ptr() for t in bufs]
        assert _equal(out.batch, eager.batch)
        for f in ("n", "n_full", "used", "alive", "window", "r0", "n_now"):
            assert torch.equal(getattr(out, f), getattr(eager, f)), f
        assert all(torch.equal(a, b) for a, b in zip(
            kept, [t for t in engine._reads(own.batch) if t is not None]))
        c = eager


def _cpu_capture(c, gate, advance):
    """The capture's stand-in: a replay calls the function again, into
    the same buffers (the gate's ``go``, the step's carry)."""
    go = gate(c)
    return (lambda: go.copy_(gate(c))), go, (lambda: advance(c, go)), c


@pytest.mark.parametrize("kind,leap", [
    ("section5", True), ("section5", False), ("late-vms", True),
    ("staggered", True), ("staggered", False), ("events", True)])
def test_replayed_drive_equals_eager_drive(monkeypatch, kind, leap):
    """The drive loop with every static block captured (here by the CPU
    stand-in) gives the eager run's bits and ``RunStats``, leaves its
    input as it was, and captures once a plan: once a run on §5, again
    after VMs placed at a later boundary, and not in dynamic blocks."""
    batch = _batch(kind)
    before = [t.clone() for t in tensor_leaves(batch)]
    eager, s_eager = engine.batched_run_stats(batch, max_steps=4096,
                                              leap=leap)
    monkeypatch.setattr(engine, "_graphable", lambda device, stream, bp:
                        stream is None and bp == STATIC)
    monkeypatch.setattr(engine._StepGraph, "_capture",
                        staticmethod(_cpu_capture))
    spans.take()
    with spans.recording():
        got, s_got = engine.batched_run_stats(batch, max_steps=4096,
                                              leap=leap)
    rec = spans.take()
    assert s_got == s_eager
    assert _equal(got, eager)
    assert all(torch.equal(a, b) for a, b in zip(tensor_leaves(batch),
                                                 before))
    n = collections.Counter(s[0] for s in rec["spans"])
    captures = rec["counters"].get("graph.captures", 0)
    assert n["drive.capture"] == captures >= 1
    assert captures <= s_got.n_plans
    assert n["step.full"] == s_got.n_steps
    # a plan's first step runs eagerly, and so do dynamic blocks' steps;
    # every other step replays
    replays = rec["counters"]["graph.replays"]
    assert 0 < replays <= s_got.n_steps - captures
    if kind != "events":
        assert replays == s_got.n_steps - captures
    if kind == "section5":
        assert captures == 1
    if kind == "late-vms":
        assert captures == 2 and s_got.n_plans >= 2
