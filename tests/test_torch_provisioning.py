"""VM provisioning in the port against the JAX package: placements, VM
and cloudlet life-cycle states, host pools and mem/storage costs exact,
for all five policies."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_conformance import POLICY_GRID, SEEDS, make_scenario
from test_torch_state import assert_same_state

from repro.core import energy as JE
from repro.core import state as JS
from repro.core.engine import run as j_run
from repro.core.provisioning import feasible_hosts as j_feasible
from repro.core.provisioning import provision_pending as j_provision
from repro_torch.core import energy
from repro_torch.core.convert import from_arrays
from repro_torch.core.engine import run
from repro_torch.core.provisioning import (BEST_FIT, FIRST_FIT, MOST_FULL,
                                           ROUND_ROBIN, WORST_FIT,
                                           feasible_hosts, provision_pending)

POLICIES = [FIRST_FIT, BEST_FIT, WORST_FIT, ROUND_ROBIN, MOST_FULL]
MARKET = dict(cost_per_cpu_sec=0.01, cost_per_mem=0.001,
              cost_per_storage=1e-4, cost_per_bw=0.002)


def _dc(hosts, vms, *, reserve=True, time=0.0):
    n = int(np.asarray(vms.req_pes).shape[0])
    cl = JS.make_cloudlets(np.arange(n, dtype=np.int32), 100.0)
    dc = JS.make_datacenter(hosts, vms, cl, reserve_pes=reserve,
                            rates=JS.make_market(**MARKET))
    return dataclasses.replace(dc, time=jnp.float32(time))


def _most_full_case():
    hosts = JS.make_hosts([4, 4], [1000.0] * 2, [4096.0, 1024.0], 1000.0,
                          1e6)
    dc = j_provision(_dc(hosts, JS.make_vms([1, 1], 1000.0, 512.0, 1.0,
                                            10.0)))
    extra = JS.make_vms([1], 1000.0, 256.0, 1.0, 10.0)
    vms = jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a, b]),
                                 dc.vms, extra)
    cl = JS.make_cloudlets(np.arange(3, dtype=np.int32), 100.0)
    return dataclasses.replace(dc, vms=vms, cloudlets=cl)


# the tests/test_provisioning.py cases (JAX-built states)
CASES = {
    "first_fit_order": lambda: _dc(JS.make_uniform_hosts(4, pes=2),
                                   JS.make_vms([1, 1, 1], 1000.0, 128.0, 1.0,
                                               10.0)),
    "memory_admission": lambda: _dc(
        JS.make_hosts([1, 1], [1000.0] * 2, [256.0, 2048.0], 1000.0, 1e6),
        JS.make_vms([1], 1000.0, 512.0, 1.0, 10.0)),
    "failed_vm": lambda: _dc(JS.make_hosts([1], [1000.0], [256.0], 1000.0,
                                           1e6),
                             JS.make_vms([1], 1000.0, 512.0, 1.0, 10.0)),
    "pe_reservation": lambda: _dc(JS.make_uniform_hosts(2, pes=1),
                                  JS.make_vms([1, 1, 1], 1000.0, 128.0, 1.0,
                                              10.0)),
    "ram_ladder": lambda: _dc(
        JS.make_hosts([1, 1, 1], [1000.0] * 3, [4096.0, 600.0, 2048.0],
                      1000.0, 1e6),
        JS.make_vms([1, 1, 1, 1], 1000.0, 512.0, 1.0, 10.0)),
    "round_robin": lambda: _dc(JS.make_uniform_hosts(3, pes=4),
                               JS.make_vms([1] * 5, 1000.0, 128.0, 1.0,
                                           10.0)),
    "most_full": _most_full_case,
    "mips_floor": lambda: _dc(
        JS.make_hosts([1, 1], [500.0, 2000.0], 4096.0, 1000.0, 1e6),
        JS.make_vms([1], 1000.0, 128.0, 1.0, 10.0)),
    "submit_gate": lambda: _dc(
        JS.make_uniform_hosts(2, pes=1),
        JS.make_vms([1, 1], 1000.0, 128.0, 1.0, 10.0,
                    submit_time=np.array([0.0, 50.0]))),
    "fcfs_by_submit": lambda: _dc(
        JS.make_uniform_hosts(1, pes=1),
        JS.make_vms([1, 1], 1000.0, 128.0, 1.0, 10.0,
                    submit_time=np.array([10.0, 0.0])), time=10.0),
    "no_reserve": lambda: _dc(JS.make_uniform_hosts(2, pes=2),
                              JS.make_vms([2, 2, 1], 1000.0, 128.0, 1.0,
                                          10.0), reserve=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("policy", POLICIES)
def test_provisioning_cases_match_jax(case, policy):
    jdc = CASES[case]()
    want = j_provision(jdc, policy)
    got = provision_pending(from_arrays(jdc, device="cpu"), policy)
    assert_same_state(got, want, f"{case} policy {policy}")


@pytest.mark.parametrize("seed", SEEDS[:12])
def test_provisioning_conformance_states_match_jax(seed):
    """Staggered VM arrivals, placed at three instants in turn."""
    for policy in POLICIES:
        for vp, tp in POLICY_GRID[:2]:
            jdc = dataclasses.replace(make_scenario(seed, vp, tp),
                                      rates=JS.make_market(**MARKET))
            tdc = from_arrays(jdc, device="cpu")
            for t in (0.0, 2.5, 5.0):
                jdc = j_provision(dataclasses.replace(
                    jdc, time=jnp.float32(t)), policy)
                tdc = provision_pending(dataclasses.replace(
                    tdc, time=torch.tensor(t, dtype=torch.float32)), policy)
                assert_same_state(tdc, jdc, f"seed {seed} policy {policy}")


def _fleet_case(seed, reserve):
    """Runs of identical VMs (the broker's fleets) on a mixed fleet of
    hosts, some invalid, some already part-used, more VMs than fit."""
    rng = np.random.default_rng(seed)
    nh = int(rng.integers(5, 30))
    hosts = JS.make_hosts(rng.integers(1, 5, nh),
                          rng.choice([500.0, 1000.0], nh),
                          rng.choice([512.0, 1024.0, 1536.0, 4096.0], nh),
                          rng.choice([10.0, 100.0], nh), 1e4)
    hosts = dataclasses.replace(
        hosts, valid=jnp.asarray(rng.uniform(size=nh) > 0.1),
        free_ram=hosts.free_ram - jnp.asarray(
            rng.choice([0.0, 256.0], nh), jnp.float32))
    classes = [(int(rng.integers(1, 3)), float(rng.choice([500.0, 1000.0])),
                float(rng.choice([256.0, 512.0, 384.5])))
               for _ in range(3)]
    runs = rng.integers(1, 12, 5)
    pick = rng.integers(0, 3, 5)
    pes, mips, ram = (np.concatenate([[classes[c][f]] * r
                                      for c, r in zip(pick, runs)])
                      for f in range(3))
    vms = JS.make_vms(pes, mips, ram, 5.0, 100.0)
    return _dc(hosts, vms, reserve=reserve)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("reserve", [True, False])
def test_fleets_of_identical_vms_match_jax(seed, reserve):
    jdc = _fleet_case(seed, reserve)
    for policy in POLICIES:
        want = j_provision(jdc, policy)
        got = provision_pending(from_arrays(jdc, device="cpu"), policy)
        assert_same_state(got, want, f"seed {seed} policy {policy}")


@pytest.mark.parametrize("case", ["memory_admission", "mips_floor",
                                  "pe_reservation", "no_reserve"])
def test_feasible_hosts_matches_jax(case):
    jdc = CASES[case]()
    tdc = from_arrays(jdc, device="cpu")
    fields = ("ram", "bw", "size", "req_pes", "req_mips")
    for v in range(int(jdc.vms.req_pes.shape[0])):
        pools = lambda h: (h.free_ram, h.free_bw, h.free_storage, h.free_pes)
        want = j_feasible(jdc, *pools(jdc.hosts),
                          **{f: getattr(jdc.vms, f)[v] for f in fields})
        got = feasible_hosts(tdc, *pools(tdc.hosts),
                             **{f: getattr(tdc.vms, f)[v] for f in fields})
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_no_vm_due_is_the_identity():
    jdc = CASES["submit_gate"]()
    tdc = from_arrays(dataclasses.replace(
        jdc, vms=dataclasses.replace(jdc.vms, submit_time=jnp.asarray(
            [5.0, 6.0], jnp.float32))), device="cpu")
    assert provision_pending(tdc) is tdc


@pytest.mark.parametrize("policy", [MOST_FULL, ROUND_ROBIN])
def test_consolidation_energy_matches_jax(policy):
    """The MOST_FULL vs ROUND_ROBIN energy study of test_provisioning,
    run to quiescence by both engines."""
    concave = np.linspace(0.0, 1.0, JE.K_CURVE) ** 0.25
    hosts = JS.make_uniform_hosts(4, pes=2, mips=1000.0, ram=4096.0,
                                  idle_w=100.0, peak_w=200.0,
                                  power_curve=concave)
    vms = JS.make_vms([1, 1, 1, 1], 1000.0, 512.0, 1.0, 10.0)
    cl = JS.make_cloudlets([0, 1, 2, 3], 60_000.0)
    jdc = JS.make_datacenter(hosts, vms, cl, vm_policy=JS.SPACE_SHARED,
                             task_policy=JS.SPACE_SHARED, reserve_pes=True)
    want = j_run(jdc, max_steps=128, provision_policy=policy, leap=False)
    got = run(from_arrays(jdc, device="cpu"), max_steps=128,
              provision_policy=policy)
    np.testing.assert_array_equal(got.vms.host.numpy(),
                                  np.asarray(want.vms.host))
    np.testing.assert_allclose(float(energy.energy_total_j(got)),
                               float(JE.energy_total_j(want)), rtol=1e-6)
    if policy == MOST_FULL:     # 2 hosts at 200 W, 2 idle at 100 W
        np.testing.assert_allclose(float(energy.energy_total_j(got)),
                                   (2 * 200.0 + 2 * 100.0) * 60.0, rtol=1e-5)
