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
from repro_torch.core import scheduling
from repro_torch.core import state as S
from repro_torch.core.convert import from_arrays
from repro_torch.core.engine import run
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
