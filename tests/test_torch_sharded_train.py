"""FSDP and tensor/expert parallelism at run time on the CPU (gloo): the
port's train step on each rank's blocks under ``param_pspecs`` against
the single-process step and JAX's ``make_train_step`` on the global
batch, the prefill on a tensor-parallel mesh against one process, a
sharded checkpoint restored on another mesh, in one process and in JAX,
and JAX's own step jitted with ``in_shardings`` from its ``param_pspecs``
on 4 fake devices against its single-device run.

One spawn of 4 ranks (``torch_ranks_worker.sharded``) builds the meshes
(4, 1) (FSDP), (1, 4) (tensor parallelism) and (2, 2) (both, with
``expert_fsdp``) in one world and runs 3 steps of each case on each;
JAX and the single-process port run here meanwhile.  The cases:
qwen3-0.6b (attention with qk-norm and GQA: at m = 4 its 2 kv heads do
not divide the model axis, so each rank reads the one its query head
needs), falcon-mamba-7b (Mamba), moonshot-v1-16b-a3b (MoE through
``moe_block_ep`` wherever the model axis is larger than 1) and
qwen3-0.6b with 3 heads of 22 (``heads`` and ``kv`` fall back to
replication on (1, 4), while ``ffn`` and ``vocab`` divide; on (2, 2) the
heads are cut but 3 heads do not split over 2 ranks, so attention runs
whole).  moonshot runs at capacity factor 64, so no pair is dropped:
JAX's expert parallelism sets a capacity per data shard, which drops
other pairs than one device does whenever pairs drop
(``test_torch_moe_ep.py`` holds the dropping case against JAX's).

Tolerances (as ``test_torch_dp.py`` states them): losses and grad norms
1e-5 relative; parameters after 3 AdamW steps within 1e-5 absolute and
relative of the single process, and 1e-5 absolute / 1e-3 relative of
JAX, except at most one element in 10,000 of a leaf (at least one), and
all within 1e-4 absolute: tensor parallelism adds each product's terms
in other groups, and where an element's gradient is at the level of
that rounding AdamW moves it by a different step.
The prefill's logits 1e-5, top-1 equal; checkpoints bitwise; JAX's
sharded losses 1e-5 relative of its single device.
"""
import dataclasses
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_ranks_worker
from repro import configs as JCFG
from repro.checkpoint import restore as j_restore
from repro.data.synthetic import config_for as j_config_for
from repro.data.synthetic import make_batch as j_make_batch
from repro.train import AdamWConfig as JAdamW
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro_torch import configs as TCFG
from repro_torch.checkpoint import restore
from repro_torch.launch.mesh import (abstract_mesh, init_ranks,
                                     make_local_mesh, rules_for_mesh,
                                     shutdown_ranks)
from repro_torch.launch.train import train
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.sharding.rules import (P, LeafCutter, ShardingRules,
                                        fsdp_dims, param_pspecs,
                                        reduced_axes, shard_leaf, spec_axes)
from repro_torch.train import (AdamWConfig, TrainConfig, init_train_state,
                               make_train_step)
from repro_torch.train.optimizer import global_norm
from repro_torch.tree import tree_flatten, tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, BATCH, SEQ, STEPS = 4, 8, 16, 3
CASES = {
    "qwen3": ("qwen3-0.6b", {}),
    "falcon": ("falcon-mamba-7b", {}),
    "moonshot": ("moonshot-v1-16b-a3b", {"capacity_factor": 64.0}),
    "qwen3-odd-heads": ("qwen3-0.6b", {"num_heads": 3, "num_kv_heads": 1,
                                       "head_dim": 22}),
}
MESHES = {"fsdp": (4, 1), "tp": (1, 4), "both": (2, 2)}
RULES = {"both": {"expert_fsdp": True}}
PREFILL = ("tp", "qwen3")
CKPT, RESTORE_ON = ("both", "qwen3"), "fsdp"
PARAM_TOL = {"single": (1e-5, 1e-5), "jax": (1e-5, 1e-3)}
OUTLIER_ATOL, OUTLIER_SHARE = 1e-4, 1e-4
RANKS_TIMEOUT = 600             # seconds for the spawned ranks

JAX_SHARDED = """
import sys
import numpy as np
import jax
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro import configs as JCFG
from repro.data.synthetic import config_for, make_batch
from repro.launch.mesh import rules_for_mesh
from repro.sharding.rules import batch_pspec, make_constrain, param_pspecs
from repro.train import AdamWConfig, TrainConfig, init_train_state
from repro.train import make_train_step
from repro.train.optimizer import OptState
from repro.train.step import TrainState
assert len(jax.devices()) == 4, jax.devices()
# jax.make_mesh's default Explicit axes fail at the embedding gather
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
rules = rules_for_mesh(mesh)
cfg = JCFG.get_smoke_config("qwen3-0.6b")
tcfg = TrainConfig(opt=AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                   total_steps=10))
state = init_train_state(cfg, tcfg, jax.random.PRNGKey(0))
ps = param_pspecs(state.params, mesh, rules)
leaf = lambda x: isinstance(x, P)
ns = lambda tree: jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                               is_leaf=leaf)
state_sh = ns(TrainState(params=ps, opt=OptState(step=P(), m=ps, v=ps),
                         ef_error=None))
batches = [make_batch(config_for(cfg, %d, %d), s) for s in range(%d)]
batch_sh = ns(jax.tree.map(lambda a: batch_pspec(mesh, rules, a.ndim, %d),
                           batches[0]))
step = jax.jit(make_train_step(cfg, tcfg,
                               constrain=make_constrain(mesh, rules, %d)),
               in_shardings=(state_sh, batch_sh))
losses = []
for b in batches:
    state, m = step(jax.device_put(state, state_sh), b)
    losses.append(float(m["loss"]))
np.save(sys.argv[1], np.asarray(losses))
""" % (BATCH, SEQ, STEPS, BATCH, BATCH)


def _cfg(arch, kw):
    return dataclasses.replace(TCFG.get_smoke_config(arch), **kw)


def _tcfgs():
    opt = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    return TrainConfig(opt=AdamWConfig(**opt)), JTrainConfig(opt=JAdamW(
        **opt))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)        # leave cores to the spawned ranks
    inputs = {"cases": {}, "meshes": MESHES, "rules": RULES,
              "prefill": PREFILL, "ckpt": CKPT, "restore_on": RESTORE_ON}
    jax_side = {}
    for name, (arch, kw) in CASES.items():
        jcfg = dataclasses.replace(JCFG.get_smoke_config(arch), **kw)
        _, jtcfg = _tcfgs()
        jstate = j_init_state(jcfg, jtcfg, jax.random.PRNGKey(0))
        scfg = j_config_for(jcfg, BATCH, SEQ)
        jbatches = [j_make_batch(scfg, s) for s in range(STEPS)]
        inputs["cases"][name] = {
            "arch": arch, "cfg": kw,
            "params": params_from_jax(_np_tree(jstate.params),
                                      _cfg(arch, kw), device="cpu"),
            "batches": [{k: torch.from_numpy(np.array(v))
                         for k, v in b.items()} for b in jbatches]}
        jax_side[name] = (jcfg, jtcfg, jstate, jbatches)
    torch.save(inputs, tmp / "inputs.pt")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    j_sharded = subprocess.Popen(
        [sys.executable, "-c", JAX_SHARDED, str(tmp / "jax_sharded.npy")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ctx = mp.spawn(torch_ranks_worker.sharded, args=(WORLD, str(tmp)),
                   nprocs=WORLD, join=False)

    single, jax_out = {}, {}
    for name, (arch, kw) in CASES.items():
        cfg, (tcfg, _) = _cfg(arch, kw), _tcfgs()
        state = init_train_state(cfg, tcfg,
                                 params=inputs["cases"][name]["params"])
        step = make_train_step(cfg, tcfg)
        losses, norms = [], []
        for b in inputs["cases"][name]["batches"]:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        single[name] = {"losses": losses, "grad_norms": norms,
                        "params": state.params}
        jcfg, jtcfg, jstate, jbatches = jax_side[name]
        jstep = jax.jit(j_make_step(jcfg, jtcfg))
        losses = []
        for b in jbatches:
            jstate, jm = jstep(jstate, b)
            losses.append(float(jm["loss"]))
        jax_out[name] = {"losses": losses, "state": jstate,
                         "params": jax.tree.leaves(_np_tree(jstate.params))}
    mesh_name, case = PREFILL
    with torch.no_grad():
        prefill, _ = M.prefill(inputs["cases"][case]["params"],
                               _cfg(*CASES[case]),
                               inputs["cases"][case]["batches"][0]["tokens"])
    deadline = time.monotonic() + RANKS_TIMEOUT
    while not ctx.join(timeout=5):
        assert time.monotonic() < deadline, "the ranks did not finish"
    torch.set_num_threads(threads)
    _, err = j_sharded.communicate(timeout=300)
    assert j_sharded.returncode == 0, err[-3000:]
    ranks = [torch.load(tmp / f"out{WORLD}_{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "single": single, "jax": jax_out,
            "prefill": prefill, "tmp": tmp,
            "jax_sharded": np.load(tmp / "jax_sharded.npy").tolist()}


def _check_params(got, want, tol):
    """Every leaf within ``tol`` but for at most OUTLIER_SHARE of its
    elements (at least one), and those within OUTLIER_ATOL (docstring)."""
    atol, rtol = tol
    paths, leaves, _ = tree_flatten(got)
    assert len(leaves) == len(want)
    for p, a, b in zip(paths, leaves, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, p
        off = np.abs(a - b) > atol + rtol * np.abs(b)
        assert off.sum() <= max(1, int(OUTLIER_SHARE * a.size)), \
            (p, int(off.sum()), float(np.abs(a - b).max()))
        np.testing.assert_allclose(a, b, atol=OUTLIER_ATOL, rtol=rtol,
                                   err_msg=p)


MESH_CASES = [(m, c) for m in MESHES for c in CASES]


@pytest.mark.parametrize("mesh,case", MESH_CASES)
def test_sharded_step_equals_single_process(runs, mesh, case):
    got = runs["ranks"][0]["train"][mesh, case]
    want = runs["single"][case]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=1e-5)
    for other in runs["ranks"][1:]:
        assert other["train"][mesh, case]["losses"] == got["losses"]
    _check_params(got["params"], tree_leaves(want["params"]),
                  PARAM_TOL["single"])


@pytest.mark.parametrize("mesh,case", MESH_CASES)
def test_sharded_step_equals_jax_on_global_batch(runs, mesh, case):
    got = runs["ranks"][0]["train"][mesh, case]
    want = runs["jax"][case]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _check_params(got["params"], want["params"], PARAM_TOL["jax"])


@pytest.mark.parametrize("mesh,case", MESH_CASES)
def test_parameters_and_moments_are_blocks(runs, mesh, case):
    """Every rank holds, for the parameters and both AdamW moments, its
    block of each leaf under ``param_pspecs`` and no more; on every mesh
    some leaf is cut."""
    whole = tree_leaves(runs["single"][case]["params"])
    cut = 0
    for r, out in enumerate(runs["ranks"]):
        res = out["train"][mesh, case]
        at = abstract_mesh(MESHES[mesh], ("data", "model"), rank=r)
        want = [tuple(shard_leaf(w, s, at).shape)
                for w, s in zip(whole, res["specs"])]
        for key in ("params", "m", "v"):
            assert res["shapes"][key] == want, key
        cut += sum(a != tuple(w.shape) for a, w in zip(want, whole))
    assert cut > 0


def test_fallback_case_replicates_heads_on_the_model_axis(runs):
    """The odd-heads case: on (1, 4) the query and kv projections are
    whole (JAX's divisibility fallback) while the MLP and the vocabulary
    are cut; on (2, 2) the query heads are cut."""
    paths = tree_flatten(runs["single"]["qwen3-odd-heads"]["params"])[0]
    for mesh, heads_cut in (("tp", False), ("both", True)):
        specs = dict(zip(paths, runs["ranks"][0]["train"][
            mesh, "qwen3-odd-heads"]["specs"]))
        assert ("model" in specs["blocks/sub0/mixer/wq"]) == heads_cut
        assert "model" in specs["blocks/sub0/mlp/gate"]
        assert "model" in specs["embed"]
    specs = dict(zip(paths, runs["ranks"][0]["train"][
        "tp", "qwen3-odd-heads"]["specs"]))
    assert "model" not in specs["blocks/sub0/mixer/wk"]


def test_prefill_on_tensor_parallel_mesh_equals_one_process(runs):
    want = runs["prefill"]
    for out in runs["ranks"]:
        got = out["prefill"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)
        assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_sharded_checkpoint_restores_on_another_mesh_bitwise(runs):
    """(2, 2)'s checkpoint restored on (4, 1): each rank's blocks are the
    saved state's blocks under (4, 1)'s specs, bit for bit."""
    saved = tree_leaves(runs["ranks"][0]["saved"])
    cut = 0
    for r, out in enumerate(runs["ranks"]):
        at = abstract_mesh(MESHES[RESTORE_ON], ("data", "model"), rank=r)
        got = tree_leaves(out["restored"])
        for a, whole, s in zip(got, saved, out["restored_specs"]):
            assert torch.equal(a, shard_leaf(whole, s, at))
            cut += a.shape != whole.shape
    assert cut > 0


def test_sharded_checkpoint_restores_whole_bitwise(runs):
    """The same checkpoint in one process (the whole state), and a
    checkpoint of the parameters alone, saved alike, in JAX: bit for
    bit."""
    saved = runs["ranks"][0]["saved"]
    got = restore(str(runs["tmp"] / "ckpt"), 3, saved)
    for a, b in zip(tree_leaves(got), tree_leaves(saved)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jparams = runs["jax"][CKPT[1]]["state"].params
    jgot = j_restore(str(runs["tmp"] / "ckpt_params"), 3, jparams)
    for a, b in zip(jax.tree.leaves(jgot), tree_leaves(saved.params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_jax_step_with_param_pspecs_equals_single_device(runs):
    """JAX's own step on (2, 2) fake devices, ``in_shardings`` from its
    ``param_pspecs``: the losses its single device gives."""
    np.testing.assert_allclose(runs["jax_sharded"],
                               runs["jax"]["qwen3"]["losses"], rtol=1e-5)


def test_spec_helpers_read_param_pspecs():
    mesh = abstract_mesh((2, 4), ("data", "model"))
    rules = rules_for_mesh(mesh)
    wq, wo, bq = P(None, "data", "model"), P(None, "model", "data"), \
        P(None, "model")
    assert spec_axes(wq) == ("data", "model") and spec_axes(bq) == ("model",)
    assert spec_axes(P(("pod", "data"), None)) == ("pod", "data")
    assert fsdp_dims(wq, rules) == [(1, ("data",))]
    assert fsdp_dims(wo, rules) == [(2, ("data",))] and not fsdp_dims(
        bq, rules)
    assert reduced_axes(wq, mesh, rules, ("data",)) == ("data",)
    assert reduced_axes(wq, mesh, rules, ()) == ()
    assert reduced_axes(bq, mesh, rules, ("data",)) == ()
    one = abstract_mesh((1, 4), ("data", "model"))
    assert spec_axes(wq, one) == ("model",)
    assert reduced_axes(wq, one, rules, ()) == ()
    assert not fsdp_dims(wq, ShardingRules(fsdp=()))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "moonshot-v1-16b-a3b"])
def test_leaf_cutter_keeps_each_rank_block_of_the_same_draws(arch):
    """``init_params(shard=LeafCutter)`` on each rank of (2, 2) holds the
    blocks of the one-process draws, and records ``param_pspecs``."""
    cfg = TCFG.get_smoke_config(arch)
    whole = M.init_params(cfg, torch.Generator().manual_seed(3),
                          device="cpu")
    rules = rules_for_mesh(abstract_mesh((2, 2), ("data", "model")))
    for r in range(4):
        mesh = abstract_mesh((2, 2), ("data", "model"), rank=r)
        cutter = LeafCutter(mesh, rules)
        mine = M.init_params(cfg, torch.Generator().manual_seed(3),
                             device="cpu", shard=cutter)
        specs = param_pspecs(whole, mesh, rules)
        assert tree_leaves(cutter.specs) == tree_leaves(specs)
        for a, w, s in zip(tree_leaves(mine), tree_leaves(whole),
                           tree_leaves(specs)):
            assert torch.equal(a, shard_leaf(w, s, mesh))


def test_global_norm_on_a_mesh_of_one_is_bitwise_the_plain_norm():
    gen = torch.Generator().manual_seed(5)
    tree = {"a": torch.randn((300, 7), generator=gen),
            "b": torch.randn((64,), generator=gen).to(torch.bfloat16),
            "c": {"d": torch.randn((4, 5, 6), generator=gen)}}
    specs = {"a": P("data", "model"), "b": P(None), "c": {"d": P(
        None, "data", None)}}
    mesh = abstract_mesh((1, 1), ("data", "model"))
    assert torch.equal(global_norm(tree, mesh, specs), global_norm(tree))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_fsdp_rules_on_world_one_train_bitwise_as_one_device(arch):
    """In-process world of one (gloo): ``train`` with FSDP rules on the
    local mesh equals ``train`` without a mesh bit for bit (every axis
    has size 1: nothing is gathered or summed)."""
    cfg = TCFG.get_smoke_config(arch)
    quiet = lambda line: None  # noqa: E731
    plain = train(cfg, steps=3, batch=4, seq=16, device="cpu", log=quiet)
    init_ranks("cpu")
    try:
        mesh = make_local_mesh()
        rep = train(cfg, steps=3, batch=4, seq=16, device="cpu", log=quiet,
                    mesh=mesh, rules=rules_for_mesh(mesh))
    finally:
        shutdown_ranks()
    assert rep.losses == plain.losses
    assert rep.grad_norms == plain.grad_norms
    for a, b in zip(tree_leaves(rep.state), tree_leaves(plain.state)):
        assert torch.equal(a, b)
