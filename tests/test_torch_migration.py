"""The port's dynamic datacenters: the event table (VM create/destroy,
host fail/recover) and live migration, on the CPU.

The counterpart of ``tests/test_migration.py`` (its federation case
waits for the port of ``core/federation.py``), with each scenario built
by the port's builders and, where the JAX test pins values, the same
values.  Also held here, against the JAX functions on the same states:
``make_events``, ``apply_due_events``, ``select_migration`` and
``apply_selected`` on random placed states from a numpy seed (both
policies, random thresholds, with and without a topology) and on
mid-run states of the dynamic conformance scenarios (converted with
``convert.from_arrays``), and
``broker.collect`` on final states with FAILED cloudlets and destroyed
VMs.  Discrete outputs exact; floats bitwise where the arithmetic is the
same, else at the stated tolerance.
"""
import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_conformance import POLICY_GRID, make_dynamic_scenario
from test_torch_state import assert_same_state

from repro.core import broker as JB
from repro.core import engine as JE
from repro.core import migration as JM
from repro.core import scheduling as JSCH
from repro.core import state as JS
from repro.oracle import simulate_dense
from repro_torch.core import broker as B
from repro_torch.core import energy, migration as M, telemetry as T
from repro_torch.core import state as S
from repro_torch.core.convert import from_arrays
from repro_torch.core.engine import (apply_due_events, run, run_stats,
                                     run_trace, wants_dynamic)

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]


def two_host_dc(**kw):
    hosts = S.make_hosts([2, 2], [100.0, 100.0], 1024.0, 1000.0, 1e6,
                         idle_w=kw.pop("idle_w", 0.0),
                         peak_w=kw.pop("peak_w", 0.0), device=CPU)
    vms = S.make_vms([1, 1], [100.0] * 2, 128.0, 10.0, 100.0, device=CPU)
    cl = S.make_cloudlets([0, 0, 1, 1], 100.0, device=CPU)
    return S.make_datacenter(hosts, vms, cl, reserve_pes=False, device=CPU,
                             **kw)


def events(times, kinds, targets):
    return S.make_events(times, kinds, targets, device=CPU)


# ---------------------------------------------------------------------------
# Event table semantics
# ---------------------------------------------------------------------------
def test_make_events_matches_jax():
    args = ([1.5, 0.25, 7.0], [S.EV_VM_DESTROY, S.EV_HOST_FAIL,
                               S.EV_VM_CREATE], [0, 3, 2])
    np.testing.assert_array_equal(S.make_events(*args, device=CPU).numpy(),
                                  np.asarray(JS.make_events(*args)))
    got = S.make_events([2.0], [S.EV_HOST_RECOVER], [1], params=0.5,
                        device=CPU)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 4)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JS.make_events([2.0], [S.EV_HOST_RECOVER],
                                               [1], params=0.5)))


def test_vm_destroy_frees_capacity_and_cancels_cloudlets():
    dc = two_host_dc(events=events([1.5], [S.EV_VM_DESTROY], [0]))
    out = run(dc, max_steps=64)
    assert int(out.vms.state[0]) == S.VM_DESTROYED
    cl_state = out.cloudlets.state.numpy()
    # VM0's first cloudlet completed at t=1 (before the destroy); the
    # second was cancelled mid-queue; VM1's pair is untouched
    assert cl_state[0] == S.CL_DONE and cl_state[1] == S.CL_FAILED
    assert np.all(cl_state[2:] == S.CL_DONE)
    # resources returned: only VM1 is still resident
    assert float(out.hosts.free_ram[0]) == 1024.0 - 128.0


def test_vm_create_event_brings_latent_slot_to_life():
    vms = S.make_vms([1, 1], [100.0] * 2, 128.0, 10.0, 100.0, device=CPU)
    vms.state[1] = S.VM_EMPTY
    hosts = S.make_hosts([2], [100.0], 1024.0, 1000.0, 1e6, device=CPU)
    cl = S.make_cloudlets([0, 0, 1, 1], 100.0, device=CPU)
    dc = S.make_datacenter(hosts, vms, cl, reserve_pes=False,
                           events=events([2.0], [S.EV_VM_CREATE], [1]),
                           device=CPU)
    out = run(dc, max_steps=64)
    assert int(out.vms.state[1]) == S.VM_ACTIVE
    # placed at max(create event, submit_time) = 2.0 s
    assert float(out.vms.create_time[1]) == 2.0
    assert bool((out.cloudlets.start_time[2:] >= 2.0).all())
    assert bool((out.cloudlets.state == S.CL_DONE).all())


def test_host_fail_evicts_and_reprovisions_with_progress_kept():
    # both VMs first-fit onto host 0; it fails at t=0.5 mid-execution
    dc = two_host_dc(events=events([0.5], [S.EV_HOST_FAIL], [0]))
    out, _ = run_trace(dc, num_steps=64)
    assert bool((out.vms.host == 1).all())
    assert bool((out.cloudlets.state == S.CL_DONE).all())
    assert not bool(out.hosts.valid[0])
    # re-placement is same-instant on an identical host: no shift
    np.testing.assert_allclose(out.cloudlets.finish_time.numpy(),
                               [1.0, 2.0, 1.0, 2.0], rtol=1e-5)


def test_host_fail_without_spare_capacity_fails_vms():
    hosts = S.make_hosts([2], [100.0], 1024.0, 1000.0, 1e6, device=CPU)
    vms = S.make_vms([1, 1], [100.0] * 2, 128.0, 10.0, 100.0, device=CPU)
    cl = S.make_cloudlets([0, 0, 1, 1], 100.0, device=CPU)
    dc = S.make_datacenter(hosts, vms, cl, reserve_pes=False,
                           events=events([0.5], [S.EV_HOST_FAIL], [0]),
                           device=CPU)
    out = run(dc, max_steps=64)
    # nowhere to go: allocation failure, unfinished cloudlets fail
    assert bool((out.vms.state == S.VM_FAILED).all())
    assert bool((out.cloudlets.state == S.CL_FAILED).all())


def test_host_recover_restores_full_capacity():
    hosts = S.make_hosts([2], [100.0], 1024.0, 1000.0, 1e6, device=CPU)
    vms = S.make_vms([1], [100.0], 128.0, 10.0, 100.0, submit_time=5.0,
                     device=CPU)
    cl = S.make_cloudlets([0], 100.0, submit_time=5.0, device=CPU)
    dc = S.make_datacenter(
        hosts, vms, cl, reserve_pes=False,
        events=events([1.0, 3.0], [S.EV_HOST_FAIL, S.EV_HOST_RECOVER],
                      [0, 0]), device=CPU)
    out = run(dc, max_steps=64)
    # the host recovered before the VM arrived: placement succeeds
    assert int(out.vms.state[0]) == S.VM_ACTIVE
    assert bool((out.cloudlets.state == S.CL_DONE).all())
    np.testing.assert_allclose(out.cloudlets.finish_time.numpy(), 6.0,
                               rtol=1e-5)


def test_events_fire_exactly_once_and_out_of_range_targets_are_noops():
    dc = two_host_dc(events=events([0.5, 0.7],
                                   [S.EV_HOST_FAIL, S.EV_VM_DESTROY],
                                   [99, -3]))
    out, _ = run_trace(dc, num_steps=64)
    assert bool(out.event_fired.all())
    assert bool(out.hosts.valid.all())
    assert bool((out.cloudlets.state == S.CL_DONE).all())
    # firing is once: re-applying events on the final state is the
    # identity, bit for bit
    assert_same_state(apply_due_events(out), out)


# ---------------------------------------------------------------------------
# Migration semantics
# ---------------------------------------------------------------------------
def test_threshold_migration_moves_mmt_victim_and_counts_delay():
    dc = two_host_dc(mig_policy=S.MIG_THRESHOLD, mig_threshold=0.9,
                     mig_energy_per_mb=0.001)
    out = run(dc, max_steps=64)
    # both VMs start on host 0 (first fit) at util 1.0 > 0.9: VM0 (the
    # lowest slot among equal-RAM victims) moves to host 1
    np.testing.assert_array_equal(out.vms.host.numpy(), [1, 0])
    assert int(out.mig_count) == 1
    # delay = ram / (bw/2) = 128 / 500 = 0.256 s of downtime
    np.testing.assert_allclose(float(out.mig_downtime), 0.256, rtol=1e-6)
    np.testing.assert_allclose(out.cloudlets.finish_time.numpy(),
                               [1.256, 2.256, 1.0, 2.0], rtol=1e-5)
    # copy joules split across both hosts: 0.5 * 128 * 0.001 each
    np.testing.assert_allclose(out.hosts.energy_j.numpy(), [0.064, 0.064],
                               rtol=1e-5)


def test_migration_off_is_inert():
    """MIG_OFF through the dynamic passes (an inert EV_NONE row switches
    them on) equals the static run, bit for bit."""
    base = run(two_host_dc(), max_steps=64)
    off = two_host_dc(mig_policy=S.MIG_OFF,
                      events=events([0.0], [S.EV_NONE], [0]))
    assert wants_dynamic(off)
    out = run(off, max_steps=64)
    np.testing.assert_array_equal(base.cloudlets.finish_time.numpy(),
                                  out.cloudlets.finish_time.numpy())
    np.testing.assert_array_equal(base.hosts.energy_j.numpy(),
                                  out.hosts.energy_j.numpy())
    assert int(out.mig_count) == 0


def test_drain_consolidates_upward_and_terminates():
    # spread start: host 1 holds the lone VM2 (least utilized), host 0 is
    # fuller; DRAIN packs VM2 onto host 0 and stops (no ping-pong)
    hosts = S.make_hosts([4, 4], [100.0, 100.0], 1024.0, 1000.0, 1e6,
                         idle_w=10.0, peak_w=50.0, device=CPU)
    vms = S.make_vms([1, 1, 1], [100.0] * 3, 128.0, 10.0, 100.0,
                     device=CPU)
    vms = dataclasses.replace(
        vms, host=torch.tensor([0, 0, 1], dtype=torch.int32),
        state=torch.full((3,), S.VM_ACTIVE, dtype=torch.int32),
        create_time=torch.zeros(3))
    hosts = dataclasses.replace(
        hosts, free_ram=hosts.free_ram - torch.tensor([256.0, 128.0]),
        free_bw=hosts.free_bw - torch.tensor([20.0, 10.0]),
        free_storage=hosts.free_storage - torch.tensor([200.0, 100.0]))
    cl = S.make_cloudlets([0, 1, 2], 200.0, device=CPU)
    dc = S.make_datacenter(hosts, vms, cl, reserve_pes=False,
                           mig_policy=S.MIG_DRAIN, mig_threshold=0.9,
                           device=CPU)
    out, trace = run_trace(dc, num_steps=128)
    assert bool((out.vms.host == 0).all())
    assert int(out.mig_count) == 1
    assert bool((out.cloudlets.state == S.CL_DONE).all())
    # quiesced: idle tail steps, no endless migration churn
    assert int(trace.active.sum()) < 128


def test_threshold_never_overloads_target():
    """The projected-utilization guard: no 1-PE VM fits under 0.5 on any
    target, so nothing migrates and all work still completes."""
    hosts = S.make_hosts([1, 1], [100.0, 100.0], 1024.0, 1000.0, 1e6,
                         device=CPU)
    vms = S.make_vms([1, 1, 1], [100.0] * 3, 128.0, 10.0, 100.0,
                     device=CPU)
    cl = S.make_cloudlets([0, 0, 1, 1, 2, 2], 400.0, device=CPU)
    dc = S.make_datacenter(hosts, vms, cl, reserve_pes=False,
                           mig_policy=S.MIG_THRESHOLD, mig_threshold=0.5,
                           device=CPU)
    out = run(dc, max_steps=256)
    assert int(out.mig_count) == 0
    assert bool((out.cloudlets.state == S.CL_DONE).all())


def test_wants_dynamic_detection():
    assert not wants_dynamic(two_host_dc())
    assert wants_dynamic(two_host_dc(mig_policy=S.MIG_THRESHOLD))
    assert wants_dynamic(two_host_dc(events=events([1.0],
                                                   [S.EV_HOST_FAIL], [0])))
    copying = two_host_dc()
    copying.vms.mig_remaining[0] = 0.5
    assert wants_dynamic(copying)


def test_migration_delay_formula():
    got = M.migration_delay(torch.tensor(128.0), torch.tensor(1000.0),
                            torch.tensor(500.0))
    assert float(got) == float(np.float32(128.0) / np.float32(250.0))
    assert float(got) == float(JM.migration_delay(
        jnp.float32(128.0), jnp.float32(1000.0), jnp.float32(500.0)))


def test_failed_host_keeps_pre_failure_energy_in_fleet_total():
    """A host down at quiescence keeps its pre-failure joules in
    ``energy_total_j``, which agrees with the trace's integral."""
    dc = two_host_dc(events=events([0.5], [S.EV_HOST_FAIL], [0]),
                     idle_w=10.0, peak_w=50.0)
    final, trace = run_trace(dc, num_steps=64)
    per_host = final.hosts.energy_j.double().numpy()
    assert per_host[0] > 0.0
    assert not bool(final.hosts.valid[0])
    total = float(energy.energy_total_j(final))
    np.testing.assert_allclose(total, per_host.sum(), rtol=1e-6)
    np.testing.assert_allclose(total, T.trace_energy_j(trace), rtol=1e-5)


def test_migration_and_failure_timelines():
    """The migration and outage timelines record the trigger, the
    downtime window and the outage interval."""
    hosts = S.make_hosts([2, 2], [100.0, 100.0], 1024.0, 1000.0, 1e6,
                         idle_w=10.0, peak_w=50.0, device=CPU)
    vms = S.make_vms([1, 1], [100.0] * 2, 128.0, 10.0, 100.0, device=CPU)
    # the 10-MI cloudlet completes at 0.1 s, inside the 0.256 s copy
    # window, so the downtime shows on the event grid
    cl = S.make_cloudlets([0, 0, 1, 1], [100.0, 100.0, 10.0, 100.0],
                          device=CPU)
    dc = S.make_datacenter(
        hosts, vms, cl, reserve_pes=False,
        events=events([6.0, 8.0], [S.EV_HOST_FAIL, S.EV_HOST_RECOVER],
                      [1, 1]),
        mig_policy=S.MIG_THRESHOLD, mig_threshold=0.9, device=CPU)
    final, trace = run_trace(dc, num_steps=64)
    t, migs, migrating = T.migration_timeline(trace)
    assert migs[-1] == int(final.mig_count) >= 1
    assert np.all(np.diff(migs) >= 0)
    assert migrating.max() >= 1
    tf, down = T.failure_timeline(trace)
    assert down.max() == 1
    # the trailing recovery applies on the quiescing step (inactive, off
    # the timeline) but lands in the final state
    assert bool(final.hosts.valid.all())
    s = T.summarize_trace(trace)
    assert s["migrations"] == int(migs[-1]) and s["peak_hosts_down"] == 1


def test_initially_failed_host_recovers_and_matches_oracle():
    """A scenario may start with a failed real host; EV_HOST_RECOVER
    brings it back, as the oracle has it."""
    hosts = JS.make_hosts([2], [100.0], 1024.0, 1000.0, 1e6, idle_w=1.0,
                          peak_w=5.0)
    hosts = dataclasses.replace(hosts, valid=jnp.zeros((1,), bool))
    jdc = JS.make_datacenter(
        hosts, JS.make_vms([1], [100.0], 128.0, 10.0, 100.0,
                           submit_time=10.0),
        JS.make_cloudlets([0], 100.0, submit_time=10.0), reserve_pes=False,
        events=JS.make_events([5.0], [S.EV_HOST_RECOVER], [0]))
    out, stats = run_stats(from_arrays(jdc, device=CPU), max_steps=32,
                           leap=False)
    res = simulate_dense(jdc)
    assert int(out.vms.state[0]) == S.VM_ACTIVE
    np.testing.assert_array_equal(out.vms.state.numpy(), res.vm_state)
    np.testing.assert_array_equal(out.cloudlets.state.numpy(), res.cl_state)
    np.testing.assert_allclose(out.cloudlets.finish_time.double().numpy(),
                               res.finish_time, rtol=0, atol=1e-3)
    np.testing.assert_allclose(out.hosts.energy_j.double().numpy(),
                               res.energy_j, rtol=0, atol=1e-3)
    assert stats.n_events == res.n_events


# ---------------------------------------------------------------------------
# Against the JAX functions, on mid-run states
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _j_step():
    return jax.jit(functools.partial(JE.step, dynamic=True))


def _mid_run(seed, vp, tp, k):
    """The JAX engine's state after ``k`` events of a dynamic scenario."""
    jdc = make_dynamic_scenario(seed, vp, tp)
    for _ in range(k):
        jdc, _ = _j_step()(jdc)
    return jdc


def _placed(seed, *, networked=False):
    """A random placed state from a numpy seed: 8 hosts of 4 PEs (one
    down), 14 VMs of 1-2 PEs placed at random (some mid-copy), 1-2
    cloudlets each, a policy and a threshold drawn at random, and with
    ``networked`` a random two-cluster topology."""
    rng = np.random.default_rng(200 + seed)
    nh, nv = 8, 14
    hosts = JS.make_hosts(np.full(nh, 4), rng.choice([500.0, 1000.0], nh),
                          4096.0, rng.choice([500.0, 1000.0], nh), 1e6,
                          idle_w=1.0, peak_w=3.0)
    pes = rng.integers(1, 3, nv)
    ram = rng.choice([64.0, 128.0, 256.0], nv)
    host = rng.integers(0, nh, nv)
    down = int(rng.integers(0, nh))
    host[host == down] = (down + 1) % nh
    vms = JS.make_vms(pes, rng.choice([500.0, 1000.0], nv), ram, 1.0, 10.0)
    mig = np.where(rng.uniform(size=nv) < 0.15,
                   np.round(rng.uniform(0.1, 2.0, nv), 2), 0.0)
    vms = dataclasses.replace(
        vms, host=jnp.asarray(host, jnp.int32),
        state=jnp.full((nv,), S.VM_ACTIVE, jnp.int32),
        create_time=jnp.asarray(np.round(rng.uniform(0, 3, nv), 2),
                                jnp.float32),
        mig_remaining=jnp.asarray(mig, jnp.float32))
    used = lambda x: jnp.asarray(np.bincount(host, weights=x, minlength=nh),
                                 jnp.float32)
    hosts = dataclasses.replace(
        hosts, free_ram=hosts.free_ram - used(ram),
        free_bw=hosts.free_bw - used(np.ones(nv)),
        free_storage=hosts.free_storage - used(np.full(nv, 10.0)),
        free_pes=hosts.free_pes - used(pes.astype(float)),
        valid=jnp.asarray(np.arange(nh) != down))
    per = rng.integers(1, 3, nv)
    cl = JS.make_cloudlets(np.repeat(np.arange(nv, dtype=np.int32), per),
                           np.round(rng.uniform(500, 5000, per.sum())))
    kw = {}
    if networked:
        kw["net"] = JS.make_topology(
            rng.integers(0, 2, nh),
            bw_intra=float(rng.choice([100.0, 400.0])), lat_intra=0.01,
            bw_inter=float(rng.choice([20.0, 64.0])), lat_inter=0.5,
            bw_wan=50.0)
    policy = int(rng.choice([S.MIG_THRESHOLD, S.MIG_DRAIN]))
    return JS.make_datacenter(
        hosts, vms, cl, reserve_pes=bool(seed % 2), mig_policy=policy,
        mig_threshold=float(np.round(rng.uniform(0.3, 0.9), 2)),
        mig_energy_per_mb=0.001, **kw)


def _assert_migration_equal(got, want, ctx):
    for name in ("trigger", "vm", "src", "dst"):
        assert int(getattr(got, name)) == int(getattr(want, name)), \
            f"{ctx} {name}"
    assert float(got.delay) == float(want.delay), f"{ctx} delay"


@pytest.mark.parametrize("seed", range(12))
def test_select_and_apply_match_jax(seed):
    """select_migration (both policies, random thresholds, half of the
    states on a topology) and apply_selected against the JAX functions:
    the decision exact, the delay and the moved state bitwise (the same
    f32 arithmetic)."""
    networked = seed % 2 == 1
    jdc = _placed(seed, networked=networked)
    jrates = JSCH.cloudlet_rates(jdc)
    want = JM.select_migration(jdc, jrates, networked=networked)
    tdc = from_arrays(jdc, device=CPU)
    got = M.select_migration(tdc, torch.tensor(np.asarray(jrates)),
                             networked=networked)
    _assert_migration_equal(got, want, seed)
    assert_same_state(M.apply_selected(tdc, got),
                      JM.apply_selected(jdc, want), str(seed))


def test_random_placed_states_trigger_both_policies():
    """The states above exercise real decisions: both policies fire."""
    fired = set()
    for seed in range(12):
        jdc = _placed(seed)
        if bool(JM.select_migration(jdc, JSCH.cloudlet_rates(jdc)).trigger):
            fired.add(int(jdc.mig_policy))
    assert fired == {S.MIG_THRESHOLD, S.MIG_DRAIN}


@pytest.mark.parametrize("seed", range(4))
def test_mid_run_decisions_match_jax(seed):
    """select_migration on mid-run states of the dynamic conformance
    scenarios (as the engine meets them) against JAX's."""
    for k in (1, 4, 9):
        vp, tp = POLICY_GRID[(seed + k) % 4]
        jdc = _mid_run(seed, vp, tp, k)
        jrates = JSCH.cloudlet_rates(jdc)
        got = M.select_migration(from_arrays(jdc, device=CPU),
                                 torch.tensor(np.asarray(jrates)))
        _assert_migration_equal(got, JM.select_migration(jdc, jrates),
                                (seed, k))


def test_apply_selected_without_trigger_is_identity():
    tdc = from_arrays(_placed(3), device=CPU)
    mig = M.Migration(trigger=torch.tensor(False), vm=torch.tensor(0),
                      src=torch.tensor(0), dst=torch.tensor(-1),
                      delay=torch.tensor(5.0))
    assert_same_state(M.apply_selected(tdc, mig), tdc)


@pytest.mark.parametrize("seed", range(6))
def test_apply_due_events_matches_jax(seed):
    """apply_due_events on mid-run states with rows due (the clock moved
    past event times): equal to JAX's, leaf for leaf."""
    vp, tp = POLICY_GRID[seed % 4]
    jdc = _mid_run(seed, vp, tp, 2 + seed)
    ev = np.asarray(jdc.events)
    t = np.float32(np.sort(ev[:, 0])[min(seed % 3, ev.shape[0] - 1)])
    jdc = dataclasses.replace(jdc, time=jnp.float32(max(t, float(jdc.time))))
    want = JE.apply_due_events(jdc)
    got = apply_due_events(from_arrays(jdc, device=CPU))
    assert_same_state(got, want, f"seed {seed}")
    assert bool(got.event_fired.any())


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_collect_on_failed_and_destroyed_matches_jax(seed):
    """broker.collect on final dynamic states (FAILED cloudlets of
    destroyed VMs and failed placements) against JAX's."""
    failed = destroyed = 0
    for vp, tp in POLICY_GRID:
        jfinal = JE.run(make_dynamic_scenario(seed, vp, tp), max_steps=512)
        want = JB.collect(jfinal)
        got = B.collect(from_arrays(jfinal, device=CPU))
        for name in want._fields:
            np.testing.assert_allclose(float(getattr(got, name)),
                                       float(getattr(want, name)),
                                       rtol=1e-6, err_msg=f"{seed} {name}")
        failed += int(got.n_failed)
        destroyed += int((np.asarray(jfinal.vms.state)
                          == S.VM_DESTROYED).sum())
    assert failed > 0 and destroyed > 0


def _example(*args, jax_platform=False):
    import os
    import subprocess
    import sys
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    if jax_platform:
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, check=True, cwd=ROOT,
                          timeout=600).stdout.splitlines()


def test_migration_study_example_matches_jax():
    """examples/torch_migration_study.py on the CPU prints the JAX
    study's table: every policy row, migration count, downtime, makespan
    and kJ."""
    got = _example("examples/torch_migration_study.py", "--device", "cpu")
    want = _example("examples/migration_study.py", jax_platform=True)
    rows = lambda lines: [line for line in lines if line.startswith("  ")]
    assert rows(got) == rows(want) and len(rows(got)) == 8
