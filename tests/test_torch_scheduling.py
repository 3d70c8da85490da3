"""Two-level scheduling in the port against the JAX package, and the
paper's Figure 3 Gantt values through the port's engine."""
import numpy as np
import pytest
import torch

from test_conformance import POLICY_GRID, SEEDS, make_scenario

from repro.core import scheduling as JSCH
from repro.core import state as JS
from repro.core.engine import run as j_run
from repro.core.provisioning import provision_pending as j_provision
from repro.oracle import simulate_dense
from repro_torch.core import scheduling
from repro_torch.core import state as S
from repro_torch.core.convert import from_arrays
from repro_torch.core.engine import run, run_stats
from repro_torch.core.provisioning import provision_pending


def _np(t):
    return t.numpy()


@pytest.mark.parametrize("seed", SEEDS[:10])
@pytest.mark.parametrize("k", [0, 3, 7])
def test_rates_match_jax_on_conformance_states(seed, k):
    """Mid-run states (after k JAX events, leap off): runnable, work and
    eligibility exact; host shares and cloudlet rates at rtol 1e-6."""
    for vp, tp in POLICY_GRID:
        jdc = make_scenario(seed, vp, tp)
        if k:
            jdc = j_run(jdc, max_steps=k, leap=False)
        jdc = j_provision(jdc)
        tdc = from_arrays(jdc, device="cpu")
        ctx = str((seed, k, vp, tp))

        j_runnable = JSCH.cloudlet_runnable(jdc)
        t_runnable = scheduling.cloudlet_runnable(tdc)
        np.testing.assert_array_equal(_np(t_runnable),
                                      np.asarray(j_runnable), err_msg=ctx)
        np.testing.assert_array_equal(
            _np(scheduling.vm_has_work(tdc, t_runnable)),
            np.asarray(JSCH.vm_has_work(jdc, j_runnable)), err_msg=ctx)

        active = jdc.vms.state == JS.VM_ACTIVE
        for elig in (active, active & JSCH.vm_has_work(jdc, j_runnable)):
            want = JSCH.host_level_shares(jdc, elig)
            got = scheduling.host_level_shares(
                tdc, torch.from_numpy(np.array(elig)))
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=1e-6, err_msg=ctx)

        np.testing.assert_allclose(_np(scheduling.cloudlet_rates(tdc)),
                                   np.asarray(JSCH.cloudlet_rates(jdc)),
                                   rtol=1e-6, err_msg=ctx)


def _fig3(vm_policy, task_policy):
    hosts = S.make_hosts([2], [100.0], 1024.0, 1000.0, 1e6, device="cpu")
    vms = S.make_vms([2, 2], [100.0] * 2, 128.0, 10.0, 100.0, device="cpu")
    cl = S.make_cloudlets([0, 0, 0, 0, 1, 1, 1, 1], 100.0, device="cpu")
    dc = S.make_datacenter(hosts, vms, cl, vm_policy=vm_policy,
                           task_policy=task_policy, reserve_pes=False,
                           device="cpu")
    out = run(dc, max_steps=64)
    return _np(out.cloudlets.start_time), _np(out.cloudlets.finish_time), out


FIG3 = {  # (vm, task) policy -> (start times, finish times), paper Fig. 3
    (S.SPACE_SHARED, S.SPACE_SHARED): ([0, 0, 1, 1, 2, 2, 3, 3],
                                       [1, 1, 2, 2, 3, 3, 4, 4]),
    (S.SPACE_SHARED, S.TIME_SHARED): ([0, 0, 0, 0, 2, 2, 2, 2],
                                      [2, 2, 2, 2, 4, 4, 4, 4]),
    (S.TIME_SHARED, S.SPACE_SHARED): ([0, 0, 2, 2, 0, 0, 2, 2],
                                      [2, 2, 4, 4, 2, 2, 4, 4]),
    (S.TIME_SHARED, S.TIME_SHARED): ([0] * 8, [4] * 8),
}


@pytest.mark.parametrize("vm_policy,task_policy", sorted(FIG3))
def test_fig3_exact(vm_policy, task_policy):
    st, ft, out = _fig3(vm_policy, task_policy)
    want_st, want_ft = FIG3[(vm_policy, task_policy)]
    np.testing.assert_array_equal(st, np.asarray(want_st, np.float32))
    np.testing.assert_array_equal(ft, np.asarray(want_ft, np.float32))
    assert torch.all(out.cloudlets.state == S.CL_DONE)


def test_time_shared_host_caps_at_demand():
    hosts = S.make_hosts([4], [100.0], 1024.0, 1000.0, 1e6, device="cpu")
    vms = S.make_vms([1], [100.0], 128.0, 10.0, 100.0, device="cpu")
    cl = S.make_cloudlets([0], 100.0, device="cpu")
    dc = S.make_datacenter(hosts, vms, cl, vm_policy=S.TIME_SHARED,
                           task_policy=S.TIME_SHARED, reserve_pes=False,
                           device="cpu")
    np.testing.assert_allclose(_np(run(dc, max_steps=16).cloudlets
                                   .finish_time), [1.0], rtol=1e-6)


def test_space_shared_fcfs_head_of_line():
    hosts = S.make_hosts([3], [100.0], 1024.0, 1000.0, 1e6, device="cpu")
    vms = S.make_vms([2, 2], [100.0] * 2, 128.0, 10.0, 100.0, device="cpu")
    cl = S.make_cloudlets([0, 1], [200.0, 100.0], device="cpu")
    dc = S.make_datacenter(hosts, vms, cl, vm_policy=S.SPACE_SHARED,
                           task_policy=S.SPACE_SHARED, reserve_pes=False,
                           device="cpu")
    np.testing.assert_allclose(_np(run(dc, max_steps=32).cloudlets
                                   .finish_time), [2.0, 3.0], rtol=1e-6)


def test_infeasible_vm_fails_at_provisioning():
    hosts = S.make_hosts([2], [100.0], 1024.0, 1000.0, 1e6, device="cpu")
    vms = S.make_vms([3, 1], [100.0] * 2, 128.0, 10.0, 100.0, device="cpu")
    cl = S.make_cloudlets([0, 1], 100.0, device="cpu")
    dc = S.make_datacenter(hosts, vms, cl, vm_policy=S.SPACE_SHARED,
                           task_policy=S.SPACE_SHARED, reserve_pes=False,
                           device="cpu")
    out = run(dc, max_steps=16)
    assert _np(out.cloudlets.state).tolist() == [S.CL_FAILED, S.CL_DONE]
    assert np.isfinite(float(out.time))


def test_rates_respect_host_capacity():
    rng = np.random.default_rng(1)
    hosts = S.make_hosts(rng.integers(1, 5, 8), 100.0, 4096.0, 1000.0, 1e6,
                         device="cpu")
    vms = S.make_vms(rng.integers(1, 3, 16), 100.0, 64.0, 1.0, 10.0,
                     device="cpu")
    owners = np.repeat(np.arange(16, dtype=np.int32), 3)
    cl = S.make_cloudlets(owners, rng.uniform(50, 500, 48).astype(
        np.float32), device="cpu")
    for vp, tp in POLICY_GRID:
        dc = provision_pending(S.make_datacenter(
            hosts, vms, cl, vm_policy=vp, task_policy=tp,
            reserve_pes=False, device="cpu"))
        rates = _np(scheduling.cloudlet_rates(dc))
        host_of = _np(dc.vms.host)[owners]
        cap = _np(dc.hosts.capacity_mips)
        for h in range(8):
            assert rates[host_of == h].sum() <= cap[h] * (1 + 1e-5)


def _skewed(vm_policy, task_policy, seed=0):
    """200 VMs, one of which holds 2,000 of the 4,000 cloudlets (the rest
    spread at random, some VMs with none).  Every cloudlet is 125 MI on
    1000-MIPS PEs, so a space-shared completion step is 0.125 s, exact in
    f32: the f32 engine sees the f64 oracle's ties as ties, and the clock
    and joule accumulators stay small (makespan <= 85 s, <= 0.25 W a
    host), as the conformance generators keep them."""
    rng = np.random.default_rng(seed)
    nv, big, vbig = 200, 2000, 57
    spread = rng.multinomial(4000 - big, np.ones(nv - 1) / (nv - 1))
    counts = np.insert(spread, vbig, big)
    pes = rng.integers(1, 3, nv)
    pes[vbig] = 4
    return S.make_datacenter(
        S.make_hosts(rng.choice([1, 2, 4], 150), 1000.0, 4096.0, 1000.0,
                     1e6, idle_w=0.05, peak_w=0.25, device="cpu"),
        S.make_vms(pes, 1000.0, 64.0, 1.0, 10.0, device="cpu"),
        S.make_cloudlets(np.repeat(np.arange(nv, dtype=np.int32), counts),
                         125.0, device="cpu"),
        vm_policy=vm_policy, task_policy=task_policy,
        reserve_pes=bool(vm_policy), device="cpu")


@pytest.mark.parametrize("vm_policy,task_policy", POLICY_GRID)
def test_skewed_binding_matches_oracle(vm_policy, task_policy):
    """A skewed binding runs to quiescence (V x Kmax is 100x C) and meets
    the docs/conformance.md contract against the f64 oracle."""
    dc = _skewed(vm_policy, task_policy)
    out, stats = run_stats(dc, max_steps=100_000)
    res = simulate_dense(dc)
    ctx = str((vm_policy, task_policy))
    np.testing.assert_array_equal(_np(out.cloudlets.state), res.cl_state,
                                  err_msg=ctx)
    assert np.all(res.cl_state == S.CL_DONE), ctx
    assert stats.n_events == res.n_events, ctx
    np.testing.assert_array_equal(_np(out.vms.host), res.vm_host, err_msg=ctx)
    for name in ("finish_time", "start_time"):
        np.testing.assert_allclose(
            _np(getattr(out.cloudlets, name)).astype(np.float64),
            getattr(res, name), rtol=0, atol=1e-3, err_msg=f"{ctx} {name}")
    np.testing.assert_allclose(_np(out.hosts.energy_j), res.energy_j, rtol=0,
                               atol=1e-3, err_msg=ctx)
