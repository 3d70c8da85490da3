"""The port's CIS registry and federation (``repro_torch.core.cis``,
``repro_torch.core.federation``) against the JAX package's, on the CPU.

Counterparts of ``tests/test_federation.py``, of
``tests/test_broker_cis.py``'s registry cases, of
``tests/test_system.py::test_full_figure5_flow`` and of
``tests/test_network.py``'s routing cases; then the port against JAX on
the same inputs: ``assign_users`` and ``cloudburst_assign`` exact on
seeded random tables with exact ties in price and capacity, ``register``
at rtol 1e-6 (exact on integer-valued parks), and ``vmap_federation``
within the ``docs/conformance.md`` tolerances (times 1e-3 s, costs 1e-4
relative; counts exact).  ``federated_run`` over a list of devices
equals ``vmap_federation`` bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import broker as JB
from repro.core import cis as JC
from repro.core import federation as JF
from repro.core import market as JM
from repro.core import state as JS
from repro.core import sweep as JSW
from repro_torch.core import broker as B
from repro_torch.core import cis
from repro_torch.core import experiments as E
from repro_torch.core import federation as F
from repro_torch.core import market as M
from repro_torch.core import state as S
from repro_torch.core import sweep
from repro_torch.core.convert import from_arrays
from repro_torch.core.engine import run

CPU = "cpu"


def _dc(cpu_rate, n_hosts=6):
    hosts = S.make_uniform_hosts(n_hosts, pes=2, mips=1000.0, device=CPU)
    vms = B.build_fleet([B.VmSpec(count=3, pes=1)], device=CPU)
    cl = B.build_waves(3, B.WaveSpec(waves=2, length_mi=20_000.0,
                                     period=15.0), device=CPU)
    return S.make_datacenter(hosts, vms, cl, reserve_pes=True,
                             rates=S.make_market(cpu_rate, 0.0, 0.0, 0.0,
                                                 device=CPU), device=CPU)


def _j_dc(cpu_rate, n_hosts=6):
    hosts = JS.make_uniform_hosts(n_hosts, pes=2, mips=1000.0)
    vms = JB.build_fleet([JB.VmSpec(count=3, pes=1)])
    cl = JB.build_waves(3, JB.WaveSpec(waves=2, length_mi=20_000.0,
                                       period=15.0))
    return JS.make_datacenter(hosts, vms, cl, reserve_pes=True,
                              rates=JS.make_market(cpu_rate, 0.0, 0.0, 0.0))


def _same_rows(a, b, ctx):
    """Two tuples of tensors equal leaf by leaf (NaN equal to NaN)."""
    for name, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, (ctx, name)
        np.testing.assert_array_equal(x.numpy(), y.numpy(),
                                      err_msg=f"{ctx} {name}")


def _same_state(a, b, ctx):
    for x, y in zip(S.tensor_leaves(a), S.tensor_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape, ctx
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=ctx)


def _table_from_jax(jt):
    return cis.CisEntry(*(torch.from_numpy(np.array(x)) for x in jt))


# ---------------------------------------------------------------------------
# Counterparts of tests/test_federation.py
# ---------------------------------------------------------------------------
def test_federated_run_matches_vmap_reference():
    """Two datacenters, one a device of a two-entry device list:
    ``federated_run`` == ``vmap_federation``, every leaf, bit for bit;
    a one-entry list too."""
    stack = sweep.stack_scenarios([_dc(0.01), _dc(0.02)])
    ov, rv, tv = F.vmap_federation(stack, max_steps=256)
    for devices in ([CPU, CPU], [CPU]):
        os_, rs, ts = F.federated_run(stack, devices=devices, max_steps=256)
        _same_state(os_, ov, f"final state, {devices}")
        _same_rows(rs, rv, f"reports, {devices}")
        _same_rows(ts, tv, f"table, {devices}")
    assert rv.n_completed.tolist() == [6, 6]
    # and the single runs, datacenter by datacenter
    for i, dc in enumerate((_dc(0.01), _dc(0.02))):
        single = run(dc, max_steps=256)
        assert float(single.cloudlets.finish_time.max()) == float(
            rv.makespan[i])
        assert float(cis.register(dc).free_pes) == float(tv.free_pes[i])


def test_assignment_prefers_cheapest_feasible():
    table = cis.stack([cis.register(_dc(0.05)), cis.register(_dc(0.01)),
                       cis.register(_dc(0.03, n_hosts=1))])
    f32 = lambda xs: torch.tensor(xs, dtype=torch.float32)
    demand = F.UserDemand(pes=f32([8.0, 8.0, 8.0]),
                          mips=f32([1000.0] * 3),
                          ram=f32([1024.0] * 3),
                          storage=f32([1000.0] * 3))
    got = F.assign_users(table, demand)
    assert got.dtype == torch.int32
    # DC1 is cheapest (12 PEs) and takes user 0; its 4 left cannot host
    # user 1, who goes to DC0; no 8 free PEs are left for user 2
    assert got.tolist() == [1, 0, -1]


def test_assignment_capacity_is_sequential():
    table = cis.stack([cis.register(_dc(0.01)), cis.register(_dc(0.01))])
    f32 = lambda xs: torch.tensor(xs, dtype=torch.float32)
    demand = F.UserDemand(pes=f32([12.0, 12.0]), mips=f32([1000.0] * 2),
                          ram=f32([512.0] * 2), storage=f32([100.0] * 2))
    got = F.assign_users(table, demand).tolist()
    assert got[0] != got[1]            # the second user takes the other DC
    assert set(got) == {0, 1}


# ---------------------------------------------------------------------------
# Counterparts of tests/test_broker_cis.py and tests/test_system.py
# ---------------------------------------------------------------------------
def _small_dc(cpu_rate=0.01, n_hosts=4):
    hosts = S.make_uniform_hosts(n_hosts, pes=2, device=CPU)
    vms = B.build_fleet([B.VmSpec(count=2, pes=1)], device=CPU)
    cl = S.make_cloudlets([0, 0, 1, 1], 30_000.0, [0.0, 10.0, 0.0, 10.0],
                          device=CPU)
    return S.make_datacenter(hosts, vms, cl, reserve_pes=True,
                             rates=S.make_market(cpu_rate, 0.001, 0.0001,
                                                 0.002, device=CPU),
                             device=CPU)


def test_register_reports_capacity():
    entry = cis.register(_small_dc())
    assert float(entry.total_pes) == 8.0
    assert float(entry.max_mips_pe) == 1000.0
    assert float(entry.free_ram) == 4 * 1024.0


def test_match_and_rank():
    table = cis.stack([cis.register(_small_dc(cpu_rate=c, n_hosts=n))
                       for c, n in [(0.05, 4), (0.01, 4), (0.02, 1)]])
    feas = cis.match(table, need_pes=4, need_mips=1000.0, need_ram=2048.0,
                     need_storage=1000.0)
    assert feas.tolist() == [True, True, False]
    order = cis.rank_by_cost(table, feas)
    assert order.dtype == torch.int32
    assert order.tolist()[:2] == [1, 0]      # cheapest feasible first


def test_full_figure5_flow():
    """register -> query -> deploy to the matched DC -> execute ->
    collect."""
    mk = lambda n, c: S.make_datacenter(
        S.make_uniform_hosts(n, pes=2, device=CPU),
        B.build_fleet([B.VmSpec(count=4)], device=CPU),
        B.build_waves(4, B.WaveSpec(waves=2, length_mi=60_000.0,
                                    period=30.0), device=CPU),
        reserve_pes=True,
        rates=S.make_market(c, 0.001, 0.0001, 0.002, device=CPU),
        device=CPU)
    dcs = [mk(8, 0.05), mk(8, 0.01)]
    table = cis.stack([cis.register(d) for d in dcs])
    feas = cis.match(table, need_pes=4, need_mips=1000.0, need_ram=2048.0,
                     need_storage=4000.0)
    pick = int(cis.rank_by_cost(table, feas)[0])
    assert pick == 1                         # the cheapest feasible provider
    rep = B.collect(run(dcs[pick], max_steps=256))
    assert int(rep.n_completed) == 8
    assert float(rep.total_cost) > 0.0


# ---------------------------------------------------------------------------
# Counterparts of tests/test_network.py's routing cases
# ---------------------------------------------------------------------------
def _routing_fixture():
    providers = [
        E.Provider(S.make_uniform_hosts(8, pes=2, device=CPU),
                   S.make_market(0.01, 1e-3, 1e-4, 2e-3, device=CPU)),
        E.Provider(S.make_uniform_hosts(8, pes=2, device=CPU),
                   S.make_market(0.05, 1e-3, 1e-4, 2e-3, device=CPU)),
    ]
    fleets = [E.UserFleet((B.VmSpec(count=2, pes=1, ram=256.0),),
                          B.WaveSpec(waves=1, length_mi=60_000.0))
              for _ in range(2)]
    # users live in region 1: provider 1 is 10 ms away, provider 0 500 ms
    lat = torch.tensor([[0.0, 0.5], [0.5, 0.01]], dtype=torch.float32)
    origin = torch.tensor([1, 1], dtype=torch.int32)
    return providers, fleets, lat, origin


def test_latency_blind_routing_is_unchanged():
    providers, fleets, lat, origin = _routing_fixture()
    demand = E.fleet_demand(fleets, device=CPU)
    _, _, table = E.build_study(providers, fleets, device=CPU)
    a = F.assign_users(table, demand)
    b = F.assign_users(table, demand, latency=None, origin=origin,
                       latency_weight=5.0)   # no matrix: weight ignored
    assert torch.equal(a, b)
    assert a.tolist() == [0, 0]              # the cheapest provider wins


def test_latency_weighted_routing_prefers_near_provider():
    providers, fleets, lat, origin = _routing_fixture()
    aware = E.build_study(providers, fleets, latency=lat, origin=origin,
                          latency_weight=1.0, device=CPU)[1]
    blind = E.build_study(providers, fleets, latency=lat, origin=origin,
                          latency_weight=0.0, device=CPU)[1]
    assert blind.tolist() == [0, 0]          # $0.01 beats $0.05 at w = 0
    assert aware.tolist() == [1, 1]          # 0.05+0.01 beats 0.01+0.5
    # end to end: run_study threads the knobs and reports transfers
    net = S.make_topology([0] * 8, bw_wan=25.0, lat_wan=0.05, device=CPU)
    providers = [dataclasses.replace(p, net=net) for p in providers]
    vm_p, task_p = sweep.policy_grid(device=CPU)
    study = E.run_study(providers, fleets, vm_p, task_p, max_steps=2048,
                        reserve_pes=False, latency=lat, origin=origin,
                        latency_weight=1.0, device=CPU)
    assert torch.equal(study.assignment, aware)
    assert study.fed_transferred_mb.shape == (4,)
    assert bool((study.fed_transferred_mb > 0.0).all())


# ---------------------------------------------------------------------------
# The port against JAX on the same inputs
# ---------------------------------------------------------------------------
def _random_table(rng, n_dc):
    """Integer capacities and prices from small sets, so rows tie
    exactly in price and in capacity."""
    pick = lambda xs: np.asarray(rng.choice(xs, n_dc), np.float32)
    cols = dict(total_pes=pick([8.0, 16.0]),
                max_mips_pe=pick([500.0, 1000.0, 2000.0]),
                free_ram=pick([2048.0, 4096.0, 8192.0]),
                free_storage=pick([4000.0, 8000.0]),
                free_bw=pick([100.0]),
                free_pes=pick([4.0, 8.0, 12.0, 16.0]),
                cost_per_cpu_sec=pick([0.01, 0.02, 0.03]),
                cost_per_mem=pick([0.001]))
    return cols


def _random_demand(rng, n_users):
    pick = lambda xs: np.asarray(rng.choice(xs, n_users), np.float32)
    return dict(pes=pick([2.0, 4.0, 6.0]), mips=pick([500.0, 1000.0]),
                ram=pick([512.0, 1024.0, 2048.0]),
                storage=pick([1000.0, 2000.0]))


def _both(cols, dem):
    jt = JC.CisEntry(**{k: jnp.asarray(v) for k, v in cols.items()})
    tt = cis.CisEntry(**{k: torch.from_numpy(v) for k, v in cols.items()})
    jd = JF.UserDemand(**{k: jnp.asarray(v) for k, v in dem.items()})
    td = F.UserDemand(**{k: torch.from_numpy(v) for k, v in dem.items()})
    return jt, tt, jd, td


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("weight", [None, 0.0, 0.5])
def test_assign_users_matches_jax(seed, weight):
    rng = np.random.default_rng(seed)
    n_dc, n_users = int(rng.integers(2, 6)), int(rng.integers(4, 14))
    jt, tt, jd, td = _both(_random_table(rng, n_dc),
                           _random_demand(rng, n_users))
    kw_j, kw_t = {}, {}
    if weight is not None:
        lat = rng.choice([0.0, 0.1, 0.2], (n_dc, n_dc)).astype(np.float32)
        origin = rng.integers(-1, n_dc + 1, n_users).astype(np.int32)
        kw_j = dict(latency=jnp.asarray(lat), origin=jnp.asarray(origin),
                    latency_weight=weight)
        kw_t = dict(latency=torch.from_numpy(lat),
                    origin=torch.from_numpy(origin), latency_weight=weight)
    want = np.asarray(JF.assign_users(jt, jd, **kw_j))
    got = F.assign_users(tt, td, **kw_t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(6))
def test_cloudburst_assign_matches_jax(seed):
    """Prices on a grid of 1/64 over integer segments: the forecast spot
    price is exact in f32, so providers tie as they do in JAX."""
    rng = np.random.default_rng(100 + seed)
    n_dc, n_users = int(rng.integers(2, 5)), int(rng.integers(4, 12))
    jt, tt, jd, td = _both(_random_table(rng, n_dc),
                           _random_demand(rng, n_users))
    tracks = []
    for _ in range(n_dc):
        n_seg = int(rng.integers(1, 4))
        times = np.concatenate([[0.0], np.sort(rng.choice(
            np.arange(1.0, 20.0), n_seg - 1, replace=False))])
        tracks.append((times, rng.integers(0, 4, n_seg) / 64.0))
    horizon = float(rng.choice([8.0, 16.0, 32.0]))
    want = np.asarray(JF.cloudburst_assign(
        jt, jd, JM.make_spot_market(tracks), horizon=horizon))
    got = F.cloudburst_assign(tt, td, M.make_spot_market(tracks, device=CPU),
                              horizon=horizon)
    np.testing.assert_array_equal(got.numpy(), want)


def _random_park(rng, n_hosts, big=False):
    pes = rng.integers(1, 5, n_hosts)
    ram = rng.choice([512.0, 1024.0, 4096.0], n_hosts)
    storage = (np.full(n_hosts, 2_000_000.0) if big
               else rng.choice([1000.0, 8000.0], n_hosts))
    mips = rng.choice([500.0, 1000.0, 2500.0], n_hosts)
    valid = rng.random(n_hosts) < 0.8
    j = JS.make_hosts(pes, mips, ram, 100.0, storage)
    j = dataclasses.replace(j, valid=jnp.asarray(valid))
    return j, from_arrays(j, device=CPU, cls=S.HostState)


@pytest.mark.parametrize("seed,n_hosts,big", [
    (0, 7, False), (1, 64, False), (2, 1000, False), (3, 40_000, True)])
def test_register_matches_jax(seed, n_hosts, big):
    """rtol 1e-6 against JAX; exact on integer-valued parks whose sums
    stay below 2^24 (the 40,000-host park sums 2 TB a host to ~6.4e10 MB,
    past it); a stacked table equals its rows bit for bit."""
    rng = np.random.default_rng(seed)
    jh, th = _random_park(rng, n_hosts, big)
    rates_j = JS.make_market(0.03, 0.002)
    rates_t = S.make_market(0.03, 0.002, device=CPU)
    mk_j = lambda h: JS.make_datacenter(
        h, JS.make_vms([1], 1000.0, 0.0, 0.0, 0.0),
        JS.make_cloudlets([0], 1.0), rates=rates_j)
    mk_t = lambda h: S.make_datacenter(
        h, S.make_vms([1], 1000.0, 0.0, 0.0, 0.0, device=CPU),
        S.make_cloudlets([0], 1.0, device=CPU), rates=rates_t, device=CPU)
    want = JC.register(mk_j(jh))
    got = cis.register(mk_t(th))
    for name, a, b in zip(got._fields, got, want):
        if big and name == "free_storage":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
    if n_hosts <= 1000:
        dcs = [mk_t(th), mk_t(_random_park(rng, n_hosts)[1])]
        table = cis.register(sweep.stack_scenarios(dcs))
        _same_rows(table, cis.stack([cis.register(d) for d in dcs]),
                   "stacked register")


def test_vmap_federation_matches_jax():
    jstack = JSW.stack_scenarios([_j_dc(0.01), _j_dc(0.02, n_hosts=2),
                                  _j_dc(0.05, n_hosts=3)])
    jo, jr, jt = JF.vmap_federation(jstack, max_steps=256)
    stack = from_arrays(jstack, device=CPU)
    out, rep, table = F.vmap_federation(stack, max_steps=256)
    np.testing.assert_array_equal(out.cloudlets.state.numpy(),
                                  np.asarray(jo.cloudlets.state))
    np.testing.assert_array_equal(out.vms.host.numpy(),
                                  np.asarray(jo.vms.host))
    np.testing.assert_allclose(out.cloudlets.finish_time.numpy(),
                               np.asarray(jo.cloudlets.finish_time),
                               atol=1e-3)
    for name in ("n_submitted", "n_completed", "n_failed"):
        np.testing.assert_array_equal(getattr(rep, name).numpy(),
                                      np.asarray(getattr(jr, name)), name)
    for name in ("makespan", "mean_response", "p99_response", "mean_exec"):
        np.testing.assert_allclose(getattr(rep, name).numpy(),
                                   np.asarray(getattr(jr, name)), atol=1e-3,
                                   err_msg=name)
    for name in ("total_cost", "cpu_cost", "mem_cost", "storage_cost",
                 "bw_cost"):
        np.testing.assert_allclose(getattr(rep, name).numpy(),
                                   np.asarray(getattr(jr, name)), rtol=1e-4,
                                   err_msg=name)
    _same_rows(table, _table_from_jax(jt), "table")
