"""The port's network subsystem: staged transfers, fair-shared flows and
topology-routed migration copies, on the CPU.

The counterpart of ``tests/test_network.py`` (its two federation-routing
cases wait for the port of ``core/federation.py``), each scenario built
by the port's builders and pinned to the JAX test's values.  Also held
here, against the JAX functions on mid-run states of the networked
conformance scenarios (the JAX engine's state after k events, converted
with ``convert.from_arrays``): ``make_topology``, ``staging_mask``,
``flow_rates``, ``wake_deltas``, ``advance_phases``,
``transfer_accounting`` and ``migration_route``.  Discrete outputs
exact; floats bitwise where the arithmetic is the same (every function
but ``transfer_accounting``, whose per-host and total sums run in the
port's fixed order: 1e-6 relative).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_conformance import (POLICY_GRID, make_networked_scenario,
                              make_scenario)
from test_torch_state import assert_same_state

from repro.core import engine as JE
from repro.core import network as JN
from repro.core import scheduling as JSCH
from repro.core import state as JS
from repro_torch.core import migration as M
from repro_torch.core import network as N
from repro_torch.core import state as S
from repro_torch.core import sweep, telemetry as T
from repro_torch.core.convert import from_arrays
from repro_torch.core.engine import run, run_stats, run_trace, wants_network

CPU = "cpu"


def one_cl_dc(*, file_size=10.0, output_size=5.0, length=100.0, **net_kw):
    """1 host / 1 VM / 1 cloudlet on a single-cluster topology."""
    net = S.make_topology([0], device=CPU, **net_kw)
    hosts = S.make_hosts([1], [100.0], 1024.0, 1000.0, 1e6, device=CPU)
    vms = S.make_vms([1], [100.0], 128.0, 10.0, 100.0, device=CPU)
    cl = S.make_cloudlets([0], length, file_size=file_size,
                          output_size=output_size, device=CPU)
    return S.make_datacenter(hosts, vms, cl, reserve_pes=False, net=net,
                             device=CPU)


def lane(batch, i):
    return S.map_tensors(lambda t: t[i], batch)


# ---------------------------------------------------------------------------
# Staged lifecycle
# ---------------------------------------------------------------------------
def test_make_topology_matches_jax():
    kw = dict(bw_intra=50.0, lat_intra=0.01, bw_inter=20.0, lat_inter=0.05,
              bw_wan=10.0, lat_wan=0.25, energy_per_mb=0.001)
    assert_same_state(S.make_topology([0, 2, 1, 0], device=CPU, **kw),
                      JS.make_topology([0, 2, 1, 0], **kw))
    assert_same_state(S.make_topology(np.arange(3), device=CPU),
                      JS.make_topology(np.arange(3)))


def test_staged_timeline_exact():
    """finish = lat + file/bw + length/mips + lat + output/bw, by hand."""
    dc = one_cl_dc(bw_intra=10.0, bw_inter=10.0, bw_wan=10.0,
                   lat_intra=0.1, lat_inter=0.2, lat_wan=0.2)
    out, trace = run_trace(dc, num_steps=32)
    # 0.5 lat + 1.0 in + 1.0 run + 0.5 lat + 0.5 out
    np.testing.assert_allclose(out.cloudlets.finish_time.numpy(), 3.5,
                               rtol=1e-6)
    # start_time is the first CPU instant, after stage-in
    np.testing.assert_allclose(out.cloudlets.start_time.numpy(), 1.5,
                               rtol=1e-6)
    assert bool((out.cloudlets.state == S.CL_DONE).all())
    np.testing.assert_allclose(float(out.net_transferred_mb), 15.0,
                               rtol=1e-6)
    t, mb, flows = T.transfer_timeline(trace)
    assert mb[-1] == 15.0 and flows.max() == 1
    summ = T.summarize_trace(trace)
    assert summ["transferred_mb"] == 15.0 and summ["peak_flows"] == 1


def test_transfer_and_link_utilization_timelines():
    """A saturated single-flow staging keeps the WAN gateway at 1.0."""
    dc = one_cl_dc(file_size=20.0, output_size=10.0, bw_intra=1e6,
                   bw_inter=1e6, bw_wan=10.0)
    _, trace = run_trace(dc, num_steps=32)
    t, mb, flows = T.transfer_timeline(trace)
    assert np.all(np.diff(mb) >= 0.0)
    np.testing.assert_allclose(mb[-1], 30.0, rtol=1e-6)
    assert flows.max() == 1
    # stage-in interval: 20 MB over [0, 2] s -> gateway utilization 1.0
    t2, util = T.link_utilization_timeline(trace, wan_bw_mbps=10.0)
    np.testing.assert_allclose(util[np.isclose(t2, 2.0)], 1.0, rtol=1e-5)


def test_fair_share_splits_bottleneck_link():
    """Four concurrent stage-ins to one host share its access fabric."""
    net = S.make_topology([0], bw_intra=10.0, bw_inter=1e6, bw_wan=1e6,
                          device=CPU)
    hosts = S.make_hosts([1], [100.0], 1024.0, 1000.0, 1e6, device=CPU)
    vms = S.make_vms([1, 1], [100.0] * 2, 128.0, 10.0, 100.0, device=CPU)
    cl = S.make_cloudlets([0, 0, 1, 1], [100.0] * 4, file_size=10.0,
                          output_size=0.0, device=CPU)
    dc = S.make_datacenter(hosts, vms, cl, reserve_pes=False, net=net,
                           vm_policy=S.TIME_SHARED,
                           task_policy=S.TIME_SHARED, device=CPU)
    out = run(dc, max_steps=128)
    # 4 flows share 10 MB/s: 10 MB each at 2.5 MB/s = 4 s in, then 4 tasks
    # time-share 100 MIPS: 100 MI each -> 4 s run
    np.testing.assert_allclose(out.cloudlets.finish_time.numpy(), 8.0,
                               rtol=1e-5)


def test_wan_is_shared_across_clusters_but_fabric_is_not():
    net = S.make_topology([0, 1], bw_intra=1e6, bw_inter=1e6, bw_wan=10.0,
                          device=CPU)
    hosts = S.make_hosts([1, 1], [100.0] * 2, 1024.0, 1000.0, 1e6,
                         device=CPU)
    vms = S.make_vms([1, 1], [100.0] * 2, 128.0, 10.0, 100.0, device=CPU)
    cl = S.make_cloudlets([0, 1], [100.0] * 2, file_size=10.0,
                          output_size=0.0, device=CPU)
    dc = S.make_datacenter(hosts, vms, cl, reserve_pes=True, net=net,
                           device=CPU)
    out = run(dc, max_steps=64)
    # one flow per cluster, still splitting the 10 MB/s gateway: 2 s
    # stage-in each, 1 s run
    np.testing.assert_array_equal(out.vms.host.numpy(), [0, 1])
    np.testing.assert_allclose(out.cloudlets.finish_time.numpy(), 3.0,
                               rtol=1e-5)


def test_zero_size_transfers_cost_no_events():
    """file = output = 0 with zero latency == the non-networked run."""
    base = one_cl_dc(file_size=0.0, output_size=0.0, bw_intra=10.0,
                     bw_inter=10.0, bw_wan=10.0)
    plain = dataclasses.replace(base, net=S.no_network(1, device=CPU))
    out_n, s_n = run_stats(base, max_steps=16)
    out_p, s_p = run_stats(plain, max_steps=16)
    np.testing.assert_array_equal(out_n.cloudlets.finish_time.numpy(),
                                  out_p.cloudlets.finish_time.numpy())
    assert s_n.n_events == s_p.n_events


def test_wants_network_detection():
    assert wants_network(one_cl_dc())
    assert not wants_network(dataclasses.replace(
        one_cl_dc(), net=S.no_network(1, device=CPU)))


def test_disabled_lane_inside_networked_batch_is_bitwise():
    """A disabled topology under the networked passes (its batch has an
    enabled lane) equals its run without them, bit for bit."""
    plain = dataclasses.replace(one_cl_dc(), net=S.no_network(1, device=CPU))
    alone = run(plain, max_steps=32)
    out = sweep.run_batch(sweep.stack_scenarios([plain, one_cl_dc()]),
                          max_steps=32)
    assert_same_state(lane(out, 0), alone)
    assert float(out.net_transferred_mb[0]) == 0.0
    assert float(out.net_transferred_mb[1]) == 15.0


def test_transfer_pauses_while_vm_unplaced():
    """A host failure mid-stage pauses the flow; it resumes once the VM
    re-provisions on the surviving host."""
    net = S.make_topology([0, 0], bw_intra=10.0, bw_inter=1e6, bw_wan=1e6,
                          device=CPU)
    hosts = S.make_hosts([1, 1], [100.0] * 2, 1024.0, 1000.0, 1e6,
                         device=CPU)
    vms = S.make_vms([1], [100.0], 128.0, 10.0, 100.0, device=CPU)
    cl = S.make_cloudlets([0], 100.0, file_size=10.0, output_size=0.0,
                          device=CPU)
    dc = S.make_datacenter(
        hosts, vms, cl, reserve_pes=False, net=net,
        events=S.make_events([0.5], [S.EV_HOST_FAIL], [0], device=CPU),
        device=CPU)
    out = run(dc, max_steps=128)
    assert int(out.vms.host[0]) == 1
    assert bool((out.cloudlets.state == S.CL_DONE).all())
    # re-placement is same-instant: 1 s in + 1 s run
    np.testing.assert_allclose(out.cloudlets.finish_time.numpy(), 2.0,
                               rtol=1e-5)
    np.testing.assert_allclose(float(out.net_transferred_mb), 10.0,
                               rtol=1e-6)


def test_staging_bills_bw_cost_and_charges_host_joules():
    dc = one_cl_dc(bw_intra=10.0, bw_inter=10.0, bw_wan=10.0,
                   energy_per_mb=0.01)
    dc = dataclasses.replace(dc, rates=S.make_market(cost_per_bw=2.0,
                                                     device=CPU))
    out = run(dc, max_steps=32)
    # 15 MB moved: $2/MB billed, 0.01 J/MB on the serving host
    np.testing.assert_allclose(float(out.acct.bw_cost), 30.0, rtol=1e-6)
    np.testing.assert_allclose(out.hosts.energy_j.numpy(), [0.15],
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# Topology-routed migration copies
# ---------------------------------------------------------------------------
def bare(**kw):
    hosts = S.make_hosts([2, 2], [100.0, 100.0], 1024.0, 1000.0, 1e6,
                         device=CPU)
    vms = S.make_vms([1, 1], [100.0] * 2, 128.0, 10.0, 100.0, device=CPU)
    cl = S.make_cloudlets([0, 0, 1, 1], 100.0, device=CPU)
    return S.make_datacenter(hosts, vms, cl, reserve_pes=False,
                             mig_policy=S.MIG_THRESHOLD, mig_threshold=0.9,
                             device=CPU, **kw)


def mig_dc(cluster, **net_kw):
    return bare(net=S.make_topology(cluster, device=CPU, **net_kw))


def test_migration_routes_same_cluster_over_intra_fabric():
    out = run(mig_dc([0, 0], bw_intra=400.0, lat_intra=0.1, bw_inter=20.0,
                     lat_inter=1.0, bw_wan=1e6), max_steps=64)
    assert int(out.mig_count) == 1
    # delay = lat_intra + ram/bw_intra = 0.1 + 128/400 = 0.42 s
    np.testing.assert_allclose(float(out.mig_downtime), 0.42, rtol=1e-5)


def test_migration_routes_cross_cluster_over_uplinks():
    out = run(mig_dc([0, 1], bw_intra=400.0, lat_intra=0.1, bw_inter=64.0,
                     lat_inter=0.5, bw_wan=1e6), max_steps=64)
    assert int(out.mig_count) == 1
    # delay = lat_inter + ram/bw_inter = 0.5 + 128/64 = 2.5 s
    np.testing.assert_allclose(float(out.mig_downtime), 2.5, rtol=1e-5)


def test_default_topology_reproduces_half_nic_delay_bitwise():
    """With the topology disabled the copy delay is ``ram / (0.5 *
    min(bw))``, bit for bit, also under the networked passes (a batch
    with an enabled lane)."""
    old = run(bare(), max_steps=64)
    np.testing.assert_allclose(float(old.mig_downtime), 0.256, rtol=1e-6)
    both = sweep.run_batch(sweep.stack_scenarios(
        [bare(), mig_dc([0, 0], bw_intra=400.0)]), max_steps=64)
    assert_same_state(lane(both, 0), old)
    rates = torch.zeros(4)
    assert float(M.select_migration(bare(), rates, networked=True).delay) \
        == float(M.select_migration(bare(), rates).delay)


# ---------------------------------------------------------------------------
# Sweep integration
# ---------------------------------------------------------------------------
def _cut(state, single):
    """``state``'s lane cut back to the entity counts of ``single``."""
    h = single.hosts.num_pes.shape[0]
    v = single.vms.req_pes.shape[0]
    c = single.cloudlets.vm.shape[0]
    e = single.events.shape[0]
    return dataclasses.replace(
        state,
        hosts=S.map_tensors(lambda t: t[:h], state.hosts),
        vms=S.map_tensors(lambda t: t[:v], state.vms),
        cloudlets=S.map_tensors(lambda t: t[:c], state.cloudlets),
        events=state.events[:e], event_fired=state.event_fired[:e],
        net=dataclasses.replace(state.net, cluster=state.net.cluster[:h]),
        metrics=dataclasses.replace(
            state.metrics, host_busy_s=state.metrics.host_busy_s[:h]))


def test_mixed_networked_lanes_batch_bitwise():
    """Networked and plain lanes stacked: every lane equals its single
    run, and the plain lanes move no byte."""
    dcs = ([from_arrays(make_networked_scenario(s, *POLICY_GRID[s % 4]),
                        device=CPU) for s in (0, 1, 3)]
           + [from_arrays(make_scenario(s, *POLICY_GRID[s % 4]),
                          device=CPU) for s in (0, 5)])
    out = sweep.run_batch(sweep.stack_scenarios(dcs), max_steps=1024)
    for i, dc in enumerate(dcs):
        single = run(dc, max_steps=1024)
        assert_same_state(_cut(lane(out, i), single), single, f"lane {i}")
    assert bool((out.net_transferred_mb[3:] == 0.0).all())
    summ = sweep.summarize_batch(out)
    assert torch.equal(summ.transferred_mb, out.net_transferred_mb)


def test_networked_grid_fused_equals_nested_bitwise():
    dcs = [from_arrays(make_networked_scenario(s, *POLICY_GRID[s % 4]),
                       device=CPU) for s in (0, 2)]
    batch = sweep.stack_scenarios(dcs)
    vm_p, task_p = sweep.policy_grid(device=CPU)
    fused = sweep.run_grid(batch, vm_p, task_p, max_steps=1024)
    nested = sweep.run_grid_nested(batch, vm_p, task_p, max_steps=1024)
    assert_same_state(fused, nested)
    for p, b in ((0, 0), (3, 1)):
        cell = dataclasses.replace(dcs[b], vm_policy=vm_p[p].clone(),
                                   task_policy=task_p[p].clone())
        single = run(cell, max_steps=1024)
        assert_same_state(_cut(S.map_tensors(lambda t: t[p, b], fused),
                               single), single, f"cell {p},{b}")


# ---------------------------------------------------------------------------
# Against the JAX functions, on mid-run states
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _j_step():
    return jax.jit(functools.partial(JE.step, dynamic=True, networked=True))


def _mid_run(seed, k):
    vp, tp = POLICY_GRID[(seed + k) % 4]
    jdc = make_networked_scenario(seed, vp, tp)
    for _ in range(k):
        jdc, _ = _j_step()(jdc)
    return jdc


def _states(seed):
    """Mid-run states of one networked scenario, with their transfers in
    every phase."""
    return [_mid_run(seed, k) for k in (0, 2, 5, 9, 14)]


@pytest.mark.parametrize("seed", range(8))
def test_flow_functions_match_jax(seed):
    """staging_mask, flow_rates and wake_deltas bitwise; the flows are
    active on some state of every scenario."""
    flowing = 0
    for jdc in _states(seed):
        tdc = from_arrays(jdc, device=CPU)
        np.testing.assert_array_equal(N.staging_mask(tdc).numpy(),
                                      np.asarray(JN.staging_mask(jdc)))
        jfr = JN.flow_rates(jdc)
        fr = N.flow_rates(tdc)
        np.testing.assert_array_equal(fr.numpy(), np.asarray(jfr))
        dt, flow_dt = N.wake_deltas(tdc, fr)
        jdt, jflow_dt = JN.wake_deltas(jdc, jfr)
        assert float(dt) == float(jdt)
        np.testing.assert_array_equal(flow_dt.numpy(), np.asarray(jflow_dt))
        flowing += int((fr > 0).sum())
    assert flowing > 0


@pytest.mark.parametrize("seed", range(8))
def test_phases_and_accounting_match_jax(seed):
    """advance_phases leaf for leaf; transfer_accounting on random drain
    masks at 1e-6 relative; migration_route bitwise for every host
    pair."""
    rng = np.random.default_rng(300 + seed)
    for jdc in _states(seed):
        tdc = from_arrays(jdc, device=CPU)
        assert_same_state(N.advance_phases(tdc), JN.advance_phases(jdc))
        drained = rng.uniform(size=tdc.cloudlets.vm.shape[0]) < 0.5
        je, jmb = JN.transfer_accounting(jdc, jnp.asarray(drained))
        te, tmb = N.transfer_accounting(tdc, torch.from_numpy(drained))
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6,
                                   atol=0)
        np.testing.assert_allclose(float(tmb), float(jmb), rtol=1e-6)
    nh = int(tdc.hosts.num_pes.shape[0])
    for src in range(nh):
        for dst in range(nh):
            got = N.migration_route(tdc, src, dst)
            want = JN.migration_route(jdc, jnp.int32(src), jnp.int32(dst))
            assert [float(x) for x in got] == [float(x) for x in want]


@pytest.mark.parametrize("seed", [1, 3, 5, 7])
def test_routed_migration_decisions_match_jax(seed):
    """select_migration under the networked gate on mid-run states of
    the odd (migrating) networked scenarios: decision and routed delay
    equal JAX's."""
    from repro.core import migration as JM
    for jdc in _states(seed):
        jrates = JSCH.cloudlet_rates(jdc, networked=True)
        want = JM.select_migration(jdc, jrates, networked=True)
        got = M.select_migration(from_arrays(jdc, device=CPU),
                                 torch.tensor(np.asarray(jrates)),
                                 networked=True)
        for name in ("trigger", "vm", "src", "dst"):
            assert int(getattr(got, name)) == int(getattr(want, name)), name
        assert float(got.delay) == float(want.delay)


def test_network_study_example_matches_jax():
    """examples/torch_network_study.py on the CPU prints the JAX study's
    WAN-contention table (its first half) row for row."""
    from test_torch_migration import _example
    got = _example("examples/torch_network_study.py", "--device", "cpu")
    want = _example("examples/network_study.py", jax_platform=True)
    names = ("space/", "time/", "staged MB")
    rows = lambda lines: [line for line in lines if line.startswith(names)]
    assert rows(got) == rows(want) and len(rows(got)) == 5
