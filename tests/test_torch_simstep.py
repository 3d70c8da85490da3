"""The port's ``simstep``: its plain version against the JAX reference and
the Pallas kernel (interpret mode), the flat<->dense gather/scatter
against JAX ``vm_level_rates`` on ragged states, and the CPU dispatch.
The CUDA kernel itself is tested in ``test_torch_cuda.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_simstep_parity import _random_tile

from repro.core import scheduling as JSCH
from repro.core import state as JS
from repro.core.provisioning import provision_pending as j_provision
from repro.kernels.simstep import simstep_pallas as j_pallas
from repro.kernels.simstep import simstep_ref as j_ref
from repro_torch.core import scheduling
from repro_torch.core.convert import from_arrays
from repro_torch.kernels.simstep import dense_index, simstep, simstep_ref
from repro_torch.kernels.simstep.ops import from_dense, to_dense

INF = 1e30


def _torch_tile(tile, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in tile]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("v,k", [(8, 16), (13, 8), (3, 128), (32, 4)])
@pytest.mark.parametrize("policy", [0, 1])
def test_ref_matches_jax_ref_and_pallas(seed, v, k, policy):
    tile = _random_tile(seed, v, k, all_idle_rows=1, zero_cap_rows=1,
                        big_pes_rows=1)
    r, d = simstep_ref(*_torch_tile(tile), policy)
    r_ref, d_ref = j_ref(*tile, policy)
    r_pal, d_pal = j_pallas(*tile, policy, interpret=True)
    for want_r, want_d in ((r_ref, d_ref), (r_pal, d_pal)):
        np.testing.assert_allclose(r.numpy(), np.asarray(want_r),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(d.numpy(), np.asarray(want_d), rtol=1e-6)


def test_ref_edge_cases():
    """All idle, pes > K, zero capacity, drained slots — as the JAX
    parity suite pins them."""
    r, d = simstep_ref(torch.full((9, 8), 100.0), torch.zeros(9, 8,
                                                              dtype=bool),
                       torch.full((9,), 500.0), torch.ones(9), 1)
    assert torch.all(r == 0.0) and torch.all(d >= INF * 0.99)
    rem, run = torch.full((4, 4), 1000.0), torch.ones(4, 4, dtype=bool)
    for policy in (0, 1):
        r, _ = simstep_ref(rem, run, torch.full((4,), 800.0),
                           torch.full((4,), 8.0), policy)
        np.testing.assert_allclose(r.numpy(), 100.0, rtol=1e-6)
    r, d = simstep_ref(torch.tensor([[0.0, 100.0, 0.0, 50.0]]),
                       torch.ones(1, 4, dtype=bool), torch.tensor([100.0]),
                       torch.tensor([2.0]), 0)
    np.testing.assert_allclose(r.numpy(), [[0.0, 50.0, 0.0, 50.0]])
    np.testing.assert_allclose(d.numpy(), [1.0])
    r, d = simstep_ref(torch.zeros(3, 0), torch.zeros(3, 0, dtype=bool),
                       torch.ones(3), torch.ones(3), 0)
    assert r.shape == (3, 0) and torch.all(d == np.float32(INF))


def test_cpu_dispatch_takes_plain_version_and_counts_nothing():
    tile = _torch_tile(_random_tile(0, 8, 16))
    before = simstep.launches
    for policy in (0, torch.tensor(1, dtype=torch.int32)):
        got = simstep(*tile, policy)
        want = simstep_ref(*tile, policy)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert simstep.launches == before


def _ragged_state(seed, vm_policy, task_policy):
    """Uneven cloudlets per VM, VMs without cloudlets, ``vm = -1`` padding
    slots, drained and finished slots; provisioned by the JAX package."""
    rng = np.random.default_rng(seed)
    nv = int(rng.integers(3, 9))
    counts = rng.integers(0, 6, nv)
    counts[rng.integers(0, nv)] = 0
    owners = []
    for vm, c in enumerate(counts):
        owners += [vm] * int(c)
        if rng.uniform() < 0.4:
            owners += [-1] * int(rng.integers(1, 3))
    owners = np.asarray(owners + [-1], np.int32)
    nc = owners.shape[0]
    hosts = JS.make_hosts(rng.integers(1, 4, 3), [500.0, 1000.0, 1000.0],
                          4096.0, 1000.0, 1e6)
    vms = JS.make_vms(rng.integers(1, 4, nv), 500.0, 64.0, 1.0, 10.0)
    cl = JS.make_cloudlets(owners, rng.uniform(100, 900, nc).astype(
        np.float32), np.round(rng.uniform(0, 2, nc), 1).astype(np.float32))
    remaining = np.asarray(cl.remaining).copy()
    remaining[rng.uniform(size=nc) < 0.15] = 0.0
    state = np.asarray(cl.state).copy()
    state[rng.uniform(size=nc) < 0.1] = JS.CL_DONE
    cl = dataclasses.replace(cl, remaining=jnp.asarray(remaining),
                             state=jnp.asarray(state))
    dc = JS.make_datacenter(hosts, vms, cl, vm_policy=vm_policy,
                            task_policy=task_policy,
                            reserve_pes=bool(seed % 2))
    dc = j_provision(dc)
    return dataclasses.replace(dc, time=jnp.float32(1.0))


@pytest.mark.parametrize("seed", range(8))
def test_gather_scatter_matches_jax_vm_level_rates(seed):
    for vp, tp in ((0, 0), (0, 1), (1, 0), (1, 1)):
        jdc = _ragged_state(seed, vp, tp)
        runnable = JSCH.cloudlet_runnable(jdc)
        active = jdc.vms.state == JS.VM_ACTIVE
        eligible = jnp.where(jdc.reserve_pes == 1, active,
                             active & JSCH.vm_has_work(jdc, runnable))
        vm_cap = JSCH.host_level_shares(jdc, eligible)
        want = np.asarray(JSCH.vm_level_rates(jdc, vm_cap, runnable))

        tdc = from_arrays(jdc, device="cpu")
        t_run = torch.from_numpy(np.array(runnable))
        t_cap = torch.from_numpy(np.array(vm_cap))
        got = scheduling.vm_level_rates(tdc, t_cap, t_run)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   err_msg=str((seed, vp, tp)))
        # the kernel's per-row minimum is the flat event-queue head
        index = dense_index(tdc.cloudlets.vm, tdc.vms.req_pes.shape[0])
        rates, dt = scheduling.rates_and_dt(tdc, index)
        rem = np.asarray(jdc.cloudlets.remaining)
        fdt = np.where(want > 0, rem / np.maximum(want, np.float32(1e-30)),
                       np.float32(INF)).astype(np.float32)
        np.testing.assert_allclose(float(dt), float(fdt.min()), rtol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_dense_index_round_trips(seed):
    rng = np.random.default_rng(seed)
    vm = torch.from_numpy(np.repeat(rng.integers(-1, 6, 10),
                                    rng.integers(0, 4, 10)).astype(np.int32))
    nv = 6
    index = dense_index(vm, nv)
    vals = torch.arange(vm.shape[0], dtype=torch.float32) + 1.0
    dense = to_dense(index, vals, 0.0)
    back = from_dense(index, dense, -1.0)
    placed = (vm >= 0) & (vm < nv)
    np.testing.assert_array_equal(back.numpy(),
                                  torch.where(placed, vals, -1.0).numpy())
    for r in range(nv):
        row = dense[r][~index.pad[r]].numpy()
        np.testing.assert_array_equal(row, vals[vm == r].numpy())
