"""The simulator's partitioners over ranks: ``sweep.run_sharded`` and
``sweep.run_grid`` with ``mesh=`` (``"shard_map"`` with both ``inner``
schemes, ``"gspmd"``, ``"auto"``) and ``federation.federated_run`` with
``mesh=``, on gloo worlds 2 and 4 (one spawn each,
``torch_ranks_worker.sweep_ranks``).

- Every rank's result equals ``run_batch`` (or the unsharded grid) bit
  for bit, every leaf: a static batch whose 5 lanes divide neither
  world, the Fig. 3 grid, a dynamic batch and an elastic batch.
- Against JAX's ``run_sharded`` (``"gspmd"`` and ``"shard_map"``) and
  ``federated_run`` on 4 fake CPU devices (a subprocess): discrete
  outputs exact, times and joules within 1e-3 (``docs/conformance.md``).
- ``federated_run(mesh=)`` at world 4 equals the device-list form bit
  for bit.
"""
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_ranks_worker
from test_conformance import (POLICY_GRID, make_dynamic_scenario,
                              make_elastic_scenario, make_scenario)
from test_torch_federation import _dc, _same_rows, _same_state

from repro_torch.core import federation as F
from repro_torch.core import sweep
from repro_torch.core.convert import from_arrays
from repro_torch.core.state import map_tensors

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPELLINGS = (("shard_map", "vmap"), ("shard_map", "map"), ("gspmd", None),
             ("auto", None))
GRID_SPELLINGS = (("shard_map", None), ("gspmd", None))
STATIC_SEEDS, GRID_SEEDS = tuple(range(5)), (0, 1, 2)
DYN_SEEDS, ELASTIC_SEEDS = (0, 2, 3), (0, 2, 4)
FED_RATES = (0.01, 0.02, 0.015, 0.03)
MAX_STEPS = {"static": 256, "grid": 192, "dynamic": 384, "elastic": 512}
WORLDS = (2, 4)
RANKS_TIMEOUT = 300             # seconds for the spawned ranks

JAX_SIDE = r'''
import pickle, sys
import numpy as np
import jax
sys.path.insert(0, "tests")
from test_conformance import POLICY_GRID, make_scenario
from test_torch_federation import _j_dc
from repro import compat
from repro.core import federation as JF
from repro.core import sweep as JSW
assert len(jax.devices()) == 4, jax.devices()
seeds, rates, steps, fsteps = pickle.load(open(sys.argv[1], "rb"))
batch = JSW.stack_scenarios([make_scenario(s, *POLICY_GRID[s % 4])
                             for s in seeds])
mesh = compat.make_mesh("sweep")
out = {}
for part in ("gspmd", "shard_map"):
    got = JSW.run_sharded(batch, mesh=mesh, max_steps=steps,
                          partitioner=part)
    out[part] = {"cl_state": np.asarray(got.cloudlets.state),
                 "vm_host": np.asarray(got.vms.host),
                 "finish": np.asarray(got.cloudlets.finish_time),
                 "energy": np.asarray(got.hosts.energy_j),
                 "time": np.asarray(got.time)}
dc_mesh = compat.make_mesh("dc")
stack = JSW.stack_scenarios([_j_dc(r) for r in rates])
# jitted: called eagerly on 4 devices, jax 0.9 refuses the table's
# replicated output sharding
fo, fr, ft = jax.jit(lambda s: JF.federated_run(dc_mesh, s,
                                                max_steps=fsteps))(stack)
out["federation"] = {"report": [np.asarray(x) for x in fr],
                     "table": [np.asarray(x) for x in ft],
                     "time": np.asarray(fo.time)}
pickle.dump(out, open(sys.argv[2], "wb"))
'''


def _port(jdc):
    return from_arrays(jdc, device="cpu")


def _batch(make, seeds, **kw):
    return sweep.stack_scenarios([_port(make(s, *POLICY_GRID[s % 4], **kw))
                                  for s in seeds])


def _cases():
    return {
        "static": {"batch": _batch(make_scenario, STATIC_SEEDS),
                   "grid": False, "spellings": SPELLINGS},
        "grid": {"batch": _batch(make_scenario, GRID_SEEDS), "grid": True,
                 "spellings": GRID_SPELLINGS},
        "dynamic": {"batch": _batch(make_dynamic_scenario, DYN_SEEDS),
                    "grid": False, "spellings": SPELLINGS[:1]},
        "elastic": {"batch": sweep.stack_scenarios(
            [_port(make_elastic_scenario(s, 0, 0)) for s in ELASTIC_SEEDS]),
            "grid": False, "spellings": SPELLINGS[2:3]},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sweep_ranks")
    cases = _cases()
    for name, case in cases.items():
        case["max_steps"] = MAX_STEPS[name]
    stack = sweep.stack_scenarios([_dc(r) for r in FED_RATES])
    fed = {"stack": stack, "max_steps": 256}
    spawned = {}
    for world in WORLDS:
        wdir = tmp / f"w{world}"
        wdir.mkdir()
        torch.save({"cases": cases, "federation": fed}, wdir / "inputs.pt")
    with open(tmp / "jax_in.pkl", "wb") as f:
        pickle.dump((STATIC_SEEDS, FED_RATES, MAX_STEPS["static"], 256), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, str(tmp / "jax_in.pkl"),
         str(tmp / "jax_out.pkl")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # leave cores to the spawned ranks
    for world in WORLDS:
        spawned[world] = mp.spawn(torch_ranks_worker.sweep_ranks,
                                  args=(world, str(tmp / f"w{world}")),
                                  nprocs=world, join=False)
    ref = {}
    for name, case in cases.items():
        kw = dict(max_steps=case["max_steps"])
        if case["grid"]:
            ref[name] = sweep.run_grid(case["batch"], *sweep.policy_grid(
                device="cpu"), sharded=False, **kw)
        else:
            ref[name] = sweep.run_batch(case["batch"], **kw)
    ref["federation"] = F.federated_run(stack, devices=["cpu"],
                                        max_steps=256)
    deadline = time.monotonic() + RANKS_TIMEOUT
    for world, ctx in spawned.items():
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the ranks did not finish"
    torch.set_num_threads(threads)
    _, err = jax_proc.communicate(timeout=RANKS_TIMEOUT)
    assert jax_proc.returncode == 0, err[-3000:]
    with open(tmp / "jax_out.pkl", "rb") as f:
        jax_out = pickle.load(f)
    ranks = {world: [torch.load(tmp / f"w{world}" / f"out{world}_{r}.pt",
                                weights_only=False) for r in range(world)]
             for world in WORLDS}
    return {"cases": cases, "ref": ref, "ranks": ranks, "jax": jax_out}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,part,inner", [
    (name, part, inner) for name, spellings in (
        ("static", SPELLINGS), ("grid", GRID_SPELLINGS),
        ("dynamic", SPELLINGS[:1]), ("elastic", SPELLINGS[2:3]))
    for part, inner in spellings])
def test_every_rank_equals_run_batch_bitwise(runs, name, part, inner,
                                             world):
    """Each rank's whole result == ``run_batch`` (the unsharded grid),
    every leaf, bit for bit."""
    want = runs["ref"][name]
    for r, got in enumerate(runs["ranks"][world]):
        _same_state(got[name, part, inner], want,
                    f"{name} {part}/{inner}, world {world}, rank {r}")
    if name == "dynamic":
        assert int(want.mig_count.sum()) > 0


def test_lanes_that_do_not_divide_the_world_come_back_unpadded(runs):
    """5 lanes on 2 and 4 ranks (padded to 6 and 8 with inert lanes):
    the result has the 5 lanes, each its single run."""
    got = runs["ranks"][4][3]["static", "gspmd", None]
    assert got.time.shape[0] == len(STATIC_SEEDS)
    from repro_torch.core.engine import run
    for i in (0, len(STATIC_SEEDS) - 1):
        lane = map_tensors(lambda t: t[i], runs["cases"]["static"]["batch"])
        _same_state(map_tensors(lambda t: t[i], got),
                    run(lane, max_steps=MAX_STEPS["static"]), f"lane {i}")


@pytest.mark.parametrize("part", ["gspmd", "shard_map"])
def test_mesh_spellings_match_jax_run_sharded(runs, part):
    """Against JAX's ``run_sharded`` on 4 fake CPU devices: states and
    placements exact, finish times, joules and clocks within 1e-3."""
    want = runs["jax"][part]
    got = runs["ranks"][4][0]["static", part, "vmap" if part == "shard_map"
                              else None]
    np.testing.assert_array_equal(got.cloudlets.state.numpy(),
                                  want["cl_state"])
    np.testing.assert_array_equal(got.vms.host.numpy(), want["vm_host"])
    for mine, theirs in ((got.cloudlets.finish_time, want["finish"]),
                         (got.hosts.energy_j, want["energy"]),
                         (got.time, want["time"])):
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=0, atol=1e-3)


def test_federated_run_on_a_mesh_equals_the_device_list_form(runs):
    """World 4, one datacenter a rank: every rank's (states, reports,
    table) == the device-list form's, bit for bit."""
    os_, rs, ts = runs["ref"]["federation"]
    for r, got in enumerate(runs["ranks"][4]):
        go, gr, gt = got["federation"]
        _same_state(go, os_, f"federation states, rank {r}")
        _same_rows(gr, rs, f"federation reports, rank {r}")
        _same_rows(gt, ts, f"federation table, rank {r}")
    assert "federation" not in runs["ranks"][2][0]


def test_federated_run_on_a_mesh_matches_jax(runs):
    """Against JAX's ``federated_run(mesh)`` on 4 fake devices: counts
    exact, costs within 1e-4 relative, times within 1e-3 s; the table
    within 1e-6 relative (the capacity sums' order differs)."""
    want = runs["jax"]["federation"]
    _, rep, table = runs["ranks"][4][1]["federation"]
    for name, mine, theirs in zip(rep._fields, rep, want["report"]):
        if name.startswith("n_"):
            np.testing.assert_array_equal(mine.numpy(), theirs, name)
        elif "cost" in name:
            np.testing.assert_allclose(mine.numpy(), theirs, rtol=1e-4,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(mine.numpy(), theirs, rtol=0,
                                       atol=1e-3, err_msg=name)
    for name, mine, theirs in zip(table._fields, table, want["table"]):
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=1e-6,
                                   err_msg=name)


def test_mesh_forms_refuse_what_jax_refuses():
    """A 2-D mesh, a devices list beside a mesh, an unknown inner or
    partitioner, and a datacenter count unlike the axis raise."""
    from repro_torch.launch.mesh import abstract_mesh
    batch = _batch(make_scenario, (0,))
    flat = abstract_mesh((2, 1), ("a", "b"))
    with pytest.raises(ValueError, match="1-D"):
        sweep.run_sharded(batch, mesh=flat)
    one = abstract_mesh((1,), ("sweep",))
    with pytest.raises(ValueError, match="not both"):
        sweep.run_sharded(batch, mesh=one, devices=["cpu"])
    with pytest.raises(ValueError, match="inner"):
        sweep.run_sharded(batch, mesh=one, inner="scan")
    with pytest.raises(ValueError, match="dispatch"):
        sweep.run_sharded(batch, mesh=one, partitioner="dispatch")
    stack = sweep.stack_scenarios([_dc(r) for r in FED_RATES[:2]])
    with pytest.raises(ValueError, match="one datacenter a rank"):
        F.federated_run(stack, mesh=abstract_mesh((4,), ("dc",)))
