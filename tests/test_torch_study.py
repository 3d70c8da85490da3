"""The port's inter-cloud policy studies (``experiments.build_study`` /
``run_study``) on the CPU.

Counterparts of
``tests/test_sweep_sharded.py::test_federation_study_cells_match_single_runs``
and ``::test_fleet_demand_aggregates``, and of
``tests/test_migration.py::test_federation_study_with_outage_and_migration``.
Then the port's ``run_study`` against JAX's on the same providers and
fleets: ``examples/intercloud_study.py``'s, a networked pair routed by
latency, a spot-cloudburst federation, and a provider that wins no user.
Assignments, completion sets, placements and counts exact; every cell's
times within 1e-3 s and costs within 1e-4 relative
(``docs/conformance.md``).  Within the port every cell equals the single
run of its datacenter, every leaf, bit for bit, however unequal the
padded lanes.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sweep import _cut
from test_torch_state import assert_same_state

from repro.core import broker as JB
from repro.core import experiments as JE
from repro.core import market as JM
from repro.core import state as JS
from repro.core import sweep as JSW
from repro_torch.core import broker as B
from repro_torch.core import experiments as E
from repro_torch.core import market as M
from repro_torch.core import state as S
from repro_torch.core import sweep
from repro_torch.core.engine import run

CPU = "cpu"
# the JAX package's builders, and the port's on the CPU
JAX = dict(S=JS, E=JE, B=JB, M=JM, SW=JSW, kw={})
PORT = dict(S=S, E=E, B=B, M=M, SW=sweep, kw=dict(device=CPU))


def _providers(pk, parks):
    """``parks``: (hosts, pes, cpu rate, extra Provider fields)."""
    S_, E_, kw = pk["S"], pk["E"], pk["kw"]
    return [E_.Provider(S_.make_uniform_hosts(n, pes=pes, ram=ram, **kw),
                        S_.make_market(rate, 1e-3, 1e-4, 2e-3, **kw),
                        **{k: (v(pk) if callable(v) else v)
                           for k, v in extra.items()})
            for n, pes, ram, rate, extra in parks]


def _fleets(pk, specs):
    """``specs``: (count, pes, ram, waves, length MI, period, file MB)."""
    B_, E_ = pk["B"], pk["E"]
    return [E_.UserFleet((B_.VmSpec(count=c, pes=p, ram=r),),
                         B_.WaveSpec(waves=w, length_mi=l, period=t,
                                     file_size=fs, output_size=fs / 4))
            for c, p, r, w, l, t, fs in specs]


def _study(pk, parks, specs, **kw):
    vm_p, task_p = pk["SW"].policy_grid(**pk["kw"])
    return pk["E"].run_study(_providers(pk, parks), _fleets(pk, specs),
                             vm_p, task_p, **kw, **pk["kw"])


def _agree(got, want):
    """The port's study against JAX's."""
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    for name in got.table._fields:
        np.testing.assert_allclose(getattr(got.table, name).numpy(),
                                   np.asarray(getattr(want.table, name)),
                                   rtol=1e-6, err_msg=name)
    for blk, name in (("cloudlets", "state"), ("vms", "state"),
                      ("vms", "host")):
        np.testing.assert_array_equal(
            getattr(getattr(got.final, blk), name).numpy(),
            np.asarray(getattr(getattr(want.final, blk), name)),
            err_msg=f"{blk}.{name}")
    np.testing.assert_allclose(got.final.cloudlets.finish_time.numpy(),
                               np.asarray(want.final.cloudlets.finish_time),
                               rtol=0, atol=1e-3)
    exact = ("n_done", "n_migrations", "n_scale_up", "n_scale_down")
    money = ("total_cost", "spot_cost")
    for name in got.summary._fields:
        g = getattr(got.summary, name).numpy()
        w = np.asarray(getattr(want.summary, name))
        assert g.shape == w.shape, name
        if name in exact:
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name in money:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=0, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-3, err_msg=name)
    np.testing.assert_array_equal(got.fed_done.numpy(),
                                  np.asarray(want.fed_done))
    np.testing.assert_array_equal(got.fed_migrations.numpy(),
                                  np.asarray(want.fed_migrations))
    np.testing.assert_allclose(got.fed_makespan.numpy(),
                               np.asarray(want.fed_makespan), atol=1e-3)
    np.testing.assert_allclose(got.fed_cost.numpy(),
                               np.asarray(want.fed_cost), rtol=1e-4)
    np.testing.assert_allclose(got.fed_transferred_mb.numpy(),
                               np.asarray(want.fed_transferred_mb),
                               atol=1e-3)


def _cells_match_single_runs(study, dcs, max_steps):
    vm_p, task_p = sweep.policy_grid(device=CPU)
    for p in range(vm_p.shape[0]):
        for d, dc in enumerate(dcs):
            cell = dataclasses.replace(dc, vm_policy=vm_p[p].clone(),
                                       task_policy=task_p[p].clone())
            single = run(cell, max_steps=max_steps)
            got = S.map_tensors(lambda t: t[p, d], study.final)
            assert_same_state(_cut(got, single), single,
                              f"cell policy={p} dc={d}")


# ---------------------------------------------------------------------------
# Counterparts of the JAX package's study tests
# ---------------------------------------------------------------------------
CELLS_PARKS = [(8, 2, 1024.0, 0.05, {}), (16, 2, 1024.0, 0.01, {})]
CELLS_FLEETS = [(8, 1, 256.0, 3, 90_000.0, 60.0, 0.0),
                (12, 1, 256.0, 2, 120_000.0, 90.0, 0.0),
                (4, 2, 256.0, 4, 60_000.0, 30.0, 0.0)]


def test_federation_study_cells_match_single_runs():
    study = _study(PORT, CELLS_PARKS, CELLS_FLEETS, max_steps=1024,
                   reserve_pes=False)
    assign = study.assignment
    assert assign.shape == (3,) and assign.dtype == torch.int32
    assert bool(((assign >= -1) & (assign < 2)).all())
    assert study.summary.n_done.shape == (4, 2)
    dcs, assignment, _ = E.build_study(_providers(PORT, CELLS_PARKS),
                                       _fleets(PORT, CELLS_FLEETS),
                                       reserve_pes=False, device=CPU)
    assert torch.equal(assignment, assign)
    _cells_match_single_runs(study, dcs, 1024)
    # a federation is work-conserving: every policy completes the same work
    assert bool((study.fed_done == study.fed_done[0]).all())
    assert torch.equal(study.fed_energy_j, study.summary.energy_j.sum(-1))


def test_fleet_demand_aggregates():
    fleet = E.UserFleet(
        (B.VmSpec(count=2, pes=2, mips=500.0, ram=256.0, size=1000.0),
         B.VmSpec(count=1, pes=1, mips=1000.0, ram=512.0, size=2000.0)),
        B.WaveSpec(waves=1))
    d = E.fleet_demand([fleet], device=CPU)
    assert d.pes.dtype == torch.float32
    assert float(d.pes[0]) == 5.0
    assert float(d.mips[0]) == 1000.0
    assert float(d.ram[0]) == 1024.0
    assert float(d.storage[0]) == 4000.0


def _outage(pk):
    return pk["S"].make_events([30.0, 60.0], [JS.EV_HOST_FAIL,
                                              JS.EV_HOST_RECOVER],
                               [0, 0], **pk["kw"])


OUTAGE_PARKS = [(6, 2, 1024.0, 0.05, dict(events=_outage)),
                (10, 2, 1024.0, 0.01, {})]
OUTAGE_FLEETS = [(8, 1, 256.0, 3, 90_000.0, 60.0, 0.0),
                 (6, 1, 256.0, 2, 120_000.0, 90.0, 0.0)]
OUTAGE_KW = dict(max_steps=2048, reserve_pes=False,
                 mig_policy=S.MIG_THRESHOLD, mig_threshold=0.8)


def test_federation_study_with_outage_and_migration():
    """Events and the migration knobs thread through build_study and
    run_study; the port agrees with JAX cell by cell."""
    study = _study(PORT, OUTAGE_PARKS, OUTAGE_FLEETS, **OUTAGE_KW)
    assert study.summary.n_migrations.shape == (4, 2)
    assert study.fed_migrations.shape == (4,)
    assert bool((study.fed_done > 0).all())
    assert torch.equal(study.fed_migrations,
                       study.summary.n_migrations.sum(-1, dtype=torch.int32))
    _agree(study, _study(JAX, OUTAGE_PARKS, OUTAGE_FLEETS, **OUTAGE_KW))
    # the outage reaches the provider that holds the fleets
    assert int(study.final.event_fired.sum()) > 0


# ---------------------------------------------------------------------------
# The port's run_study against JAX's
# ---------------------------------------------------------------------------
INTERCLOUD_PARKS = [(12, 2, 1024.0, 0.05, {}), (20, 2, 1024.0, 0.01, {}),
                    (6, 2, 1024.0, 0.02, {})]
INTERCLOUD_FLEETS = [(20, 1, 256.0, 3, 240_000.0, 120.0, 0.0),
                     (16, 1, 256.0, 4, 120_000.0, 60.0, 0.0),
                     (12, 1, 256.0, 2, 360_000.0, 300.0, 0.0),
                     (8, 1, 256.0, 5, 60_000.0, 30.0, 0.0),
                     (12, 1, 256.0, 3, 180_000.0, 90.0, 0.0)]


def test_intercloud_study_matches_jax():
    """``examples/intercloud_study.py``'s providers and fleets."""
    got = _study(PORT, INTERCLOUD_PARKS, INTERCLOUD_FLEETS, max_steps=4096,
                 reserve_pes=False)
    want = _study(JAX, INTERCLOUD_PARKS, INTERCLOUD_FLEETS, max_steps=4096,
                  reserve_pes=False)
    _agree(got, want)
    assert got.assignment.tolist() == [1, 1, 2, 0, 0]
    # the four policies differ in response, not in the work done
    resp = got.summary.mean_response
    assert len({round(float(r), 3) for r in resp[:, 1]}) > 1
    assert bool((got.fed_done == got.fed_done[0]).all())


def _net(bw_wan, lat_wan):
    return lambda pk: pk["S"].make_topology(
        [0] * 8, bw_intra=500.0, bw_inter=200.0, bw_wan=bw_wan,
        lat_wan=lat_wan, **pk["kw"])


NET_PARKS = [(8, 2, 4096.0, 0.01, dict(net=_net(20.0, 0.25))),
             (8, 2, 4096.0, 0.03, dict(net=_net(100.0, 0.01)))]
NET_FLEETS = [(4, 1, 256.0, 2, 30_000.0, 60.0, 120.0)] * 4


@pytest.mark.parametrize("weight", [0.0, 0.1])
def test_networked_latency_routed_study_matches_jax(weight):
    """``examples/network_study.py``'s routing half: a cheap far provider
    behind a narrow WAN and a pricier near one; users in region 1."""
    lat = np.asarray([[0.0, 0.4], [0.4, 0.005]], np.float32)
    origin = np.asarray([1, 1, 1, 1], np.int32)
    kw = dict(max_steps=8192, reserve_pes=True, latency_weight=weight)
    got = _study(PORT, NET_PARKS, NET_FLEETS, latency=torch.from_numpy(lat),
                 origin=torch.from_numpy(origin), **kw)
    want = _study(JAX, NET_PARKS, NET_FLEETS, latency=jnp.asarray(lat),
                  origin=jnp.asarray(origin), **kw)
    _agree(got, want)
    assert bool((got.fed_transferred_mb > 0.0).all())
    assert (got.assignment == 1).any() == (weight > 0.0)


SPOT_PARKS = [(16, 2, 1024.0, 0.01, {}), (16, 2, 1024.0, 0.03, {}),
              (16, 2, 1024.0, 0.02, {})]
SPOT_FLEETS = [(8, 1, 256.0, 2, 60_000.0, 60.0, 0.0)] * 5
SPOT_TRACKS = [([0.0, 100.0], [0.02, 0.09]), ([0.0], [0.005]),
               ([0.0, 50.0, 150.0], [0.01, 0.04, 0.02])]


def test_spot_cloudburst_study_matches_jax():
    """Forecast spot prices turn the routing: the list-price broker
    sends the first fleets to provider 0, the cloudburst broker to
    provider 1."""
    kw = dict(max_steps=4096, reserve_pes=True, spot_horizon=200.0)
    got = _study(PORT, SPOT_PARKS, SPOT_FLEETS,
                 spot=M.make_spot_market(SPOT_TRACKS, device=CPU), **kw)
    want = _study(JAX, SPOT_PARKS, SPOT_FLEETS,
                  spot=JM.make_spot_market(SPOT_TRACKS), **kw)
    _agree(got, want)
    blind = _study(PORT, SPOT_PARKS, SPOT_FLEETS, max_steps=4096,
                   reserve_pes=True)
    assert int(blind.assignment[0]) == 0
    assert int(got.assignment[0]) == 1
    assert not torch.equal(blind.assignment, got.assignment)


UNEVEN_PARKS = [(2, 4, 2048.0, 0.01, {}), (40, 1, 1024.0, 0.02, {}),
                (5, 2, 1024.0, 0.09, {})]
UNEVEN_FLEETS = [(8, 1, 256.0, 2, 30_000.0, 20.0, 0.0),
                 (30, 1, 512.0, 3, 50_000.0, 40.0, 0.0)]


def test_provider_without_users_is_inert():
    """A provider that wins no user keeps one VM_EMPTY slot and one
    CL_EMPTY cloudlet of no VM: its lane never steps, its neighbours of
    very different sizes equal their single runs, and JAX agrees."""
    got = _study(PORT, UNEVEN_PARKS, UNEVEN_FLEETS, max_steps=2048)
    want = _study(JAX, UNEVEN_PARKS, UNEVEN_FLEETS, max_steps=2048)
    _agree(got, want)
    assert got.assignment.tolist() == [0, 1]
    idle = S.map_tensors(lambda t: t[:, 2], got.final)
    assert bool((idle.time == 0.0).all())
    assert int(idle.vms.state[:, 0].ne(S.VM_EMPTY).sum()) == 0
    assert bool((idle.cloudlets.state[:, 0] == S.CL_EMPTY).all())
    assert int(got.summary.n_done[:, 2].sum()) == 0
    dcs, _, _ = E.build_study(_providers(PORT, UNEVEN_PARKS),
                              _fleets(PORT, UNEVEN_FLEETS), device=CPU)
    assert dcs[2].vms.req_pes.shape == (1,)
    assert int(dcs[2].cloudlets.vm[0]) == -1
    _cells_match_single_runs(got, dcs, 2048)
