"""The port's host spans and counters (``repro_torch.spans``), on the CPU.

The recorder is off by default, a running profiler included, and then
hands back one shared no-op;
recording changes no result (final state bit for bit, ``RunStats``);
every span lies inside its parent; and the run loop's spans count what
``RunStats`` counts: a ``drive.plan`` a plan built (``n_plans``), a
``step.full`` a full step (``n_steps``), a ``step.leap`` a leap
iteration (``n_leap``), on a static §5 batch, a batch whose leap
windows open, and one with due event-table rows.
"""
import collections
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core import broker as B
from repro_torch.core import state as S
from repro_torch.core import sweep
from repro_torch.core.engine import batched_run_stats
from repro_torch.core.state import tensor_leaves

CPU = "cpu"


def _section5(seed, events=None):
    """The paper's §5 at a tiny size: 1-PE hosts, waves of 1.2M MI."""
    hosts = S.make_uniform_hosts(12, device=CPU)
    vms = B.build_fleet([B.VmSpec(count=4, pes=1, mips=1000.0, ram=512.0,
                                  bw=10.0, size=1000.0)], device=CPU)
    cl = B.build_waves(4, B.WaveSpec(waves=3), device=CPU)
    return S.make_datacenter(hosts, vms, cl, task_policy=seed % 2,
                             events=events, device=CPU)


def _staggered(seed):
    """Reserved PEs and jittered lengths: completions that reshuffle no
    surviving rate, so the leap's windows open."""
    rng = np.random.default_rng(seed)
    hosts = S.make_uniform_hosts(8, pes=2, ram=2048.0, device=CPU)
    vms = B.build_fleet([B.VmSpec(count=6, pes=1, mips=1000.0, ram=512.0,
                                  bw=10.0, size=1000.0)], device=CPU)
    cl = B.build_waves(6, B.WaveSpec(waves=3, length_mi=600_000.0,
                                     period=300.0), device=CPU)
    jit = torch.from_numpy(
        (1.0 + 0.4 * rng.random(tuple(cl.length.shape))).astype(np.float32))
    cl = dataclasses.replace(cl, length=cl.length * jit,
                             remaining=cl.remaining * jit)
    return S.make_datacenter(hosts, vms, cl, vm_policy=S.SPACE_SHARED,
                             task_policy=S.TIME_SHARED, reserve_pes=True,
                             device=CPU)


def _events(seed):
    """§5 with a host failure, its recovery and a VM destroyed:
    due event rows move VMs at block boundaries."""
    return _section5(seed, S.make_events(
        [400.0 + 100.0 * seed, 1500.0, 900.0],
        [S.EV_HOST_FAIL, S.EV_HOST_RECOVER, S.EV_VM_DESTROY], [0, 0, 3],
        device=CPU))


MAKE = {"section5": _section5, "staggered": _staggered, "events": _events}


def _batch(kind):
    return sweep.stack_scenarios([MAKE[kind](seed) for seed in (0, 1)])


def _run(batch):
    return batched_run_stats(batch, max_steps=4096)


@pytest.mark.parametrize("profiled", [False, True])
def test_off_by_default_records_nothing(profiled):
    """Off, and off under a running ``torch.profiler`` too: only
    ``recording()`` switches the recorder on."""
    spans.take()
    prof = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]) if profiled
        else contextlib.nullcontext())
    with prof:
        assert spans.span("drive") is spans.NOOP
        assert spans.span("sync.drive.read") is spans.NOOP
        spans.count("provision.lanes", 3)
        _run(_batch("section5"))
    assert spans.take() == {"spans": [], "counters": {}}


def test_take_refuses_inside_an_open_span():
    with spans.recording():
        with spans.span("outer"):
            with pytest.raises(RuntimeError, match="outer"):
                spans.take()
    assert [s[0] for s in spans.take()["spans"]] == ["outer"]


@pytest.mark.parametrize("kind", sorted(MAKE))
def test_recording_changes_nothing_and_counts_what_runstats_counts(kind):
    spans.take()
    off, s_off = _run(_batch(kind))
    with spans.recording():
        on, s_on = _run(_batch(kind))
    rec = spans.take()
    assert s_on == s_off
    for a, b in zip(tensor_leaves(on), tensor_leaves(off)):
        assert a.dtype == b.dtype and torch.equal(a, b)

    got = rec["spans"]
    for i, (name, a, b, parent) in enumerate(got):
        assert a <= b, name
        if parent >= 0:
            assert parent < i
            _, pa, pb, _ = got[parent]
            assert pa <= a and b <= pb, (name, got[parent][0])
    n = collections.Counter(s[0] for s in got)
    assert n["drive"] == 1 and n["drive.lanes"] == 1
    assert n["drive.plan"] == s_on.n_plans
    assert n["step.full"] == s_on.n_steps
    assert n["step.leap"] == s_on.n_leap
    assert rec["counters"]["provision.lanes"] >= 2
    assert rec["counters"]["provision.vms"] >= 8
    if kind == "staggered":
        assert s_on.n_leap > 0
    if kind == "events":
        assert s_on.n_plans > 1 and n["drive.events"] > 0
    # a block's read is one wait for the device; the pass checks wait
    # before the loop, every other wait inside a layer's span
    assert n["sync.drive.read"] == n["drive.read"] > 0
    assert all(s[3] >= 0 for s in got if s[0].startswith("sync.")
               and not s[0].startswith("sync.passes."))
