"""Training across ranks on the CPU (gloo): the port's data-parallel train
step against the single-process step and JAX's ``make_train_step`` on the
global batch, the MoE block's global routing against JAX's single-device
``moe_block``, ``allreduce_compressed`` against JAX's on 4 fake devices,
a supervised restart under ranks, and an elastic restore across world
sizes.

One spawn of 2 ranks and one of 4 (``torch_ranks_worker.dp``) run every
rank-side check; JAX and the single-process port run here meanwhile.

Tolerances: losses 1e-5 relative (they agree within 2e-7).  Parameters
after 3 steps (AdamW, peak lr 1e-3; the sums over ranks add in another
order than one process's, and AdamW divides by the square roots of small
second moments): against the single process within 1e-5 absolute and
relative; against JAX within JAX's single-process tolerance of
``test_torch_train.py::test_train_step_matches_jax`` (1e-5 absolute,
1e-3 relative), since the one-process port already parts from JAX by
~1e-5 there.  With ``pod_compression`` an element whose gradient lies
within rounding of an int8 half-step can round the other way, and AdamW
then moves it by up to about lr: its parameters are held to 1e-4
absolute.  The MoE output 1e-5, its load-balance loss 1e-6 and its
``dropped_frac`` exactly; ``allreduce_compressed`` 1e-6 against JAX and
bitwise against its plain form; restarts, restores and the world-1 step
bitwise.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_ranks_worker
from repro import configs as JCFG
from repro.data.synthetic import config_for as j_config_for
from repro.data.synthetic import make_batch as j_make_batch
from repro.models import moe as j_moe
from repro.train import AdamWConfig as JAdamW
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro_torch import configs as TCFG
from repro_torch.checkpoint import restore
from repro_torch.data.synthetic import config_for, make_batch, shard_batch
from repro_torch.launch.mesh import (abstract_mesh, init_ranks,
                                     make_local_mesh, rules_for_mesh,
                                     shutdown_ranks)
from repro_torch.models.convert import params_from_jax
from repro_torch.sharding.rules import (P, make_constrain, param_pspecs,
                                        shard_leaf)
from repro_torch.train import (AdamWConfig, TrainConfig, init_train_state,
                               make_train_step)
from repro_torch.train.compression import dequantize_int8, quantize_int8
from repro_torch.train.optimizer import OptState
from repro_torch.tree import tree_flatten, tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
BATCH, SEQ, STEPS = 8, 16, 3
# name: (arch, config overrides, TrainConfig overrides)
CASES = {
    "qwen3": ("qwen3-0.6b", {}, {}),
    "falcon-mb2": ("falcon-mamba-7b", {}, {"microbatches": 2}),
    # capacity factor 0.5 drops about a third of the pairs
    "moonshot-drop": ("moonshot-v1-16b-a3b", {"capacity_factor": 0.5}, {}),
    "qwen3-ef": ("qwen3-0.6b", {}, {"pod_compression": True}),
}
# parameter tolerances (absolute, relative) against the single process
# and against JAX; int8 rounding flips under pod_compression (docstring)
PARAM_TOL = {"single": (1e-5, 1e-5), "jax": (1e-5, 1e-3)}
EF_ATOL = 1e-4
MOE_ARCH, MOE_FACTORS = "moonshot-v1-16b-a3b", (64.0, 0.5)

JAX_ALLREDUCE = """
import sys
import numpy as np
import jax
from repro import compat
from repro.train.compression import allreduce_compressed
tree = dict(np.load(sys.argv[1]))
mesh = compat.make_mesh("pod")
assert mesh.shape["pod"] == 4, mesh.shape
out = allreduce_compressed(mesh, "pod", {k: jax.numpy.asarray(v)
                                         for k, v in tree.items()})
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _jcfg(arch, kw):
    return dataclasses.replace(JCFG.get_smoke_config(arch), **kw)


def _tcfgs(kw):
    opt = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    return TrainConfig(opt=AdamWConfig(**opt), **kw), \
        JTrainConfig(opt=JAdamW(**opt), **kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _check_params(case, got, want, against):
    atol, rtol = PARAM_TOL[against]
    if CASES[case][2].get("pod_compression"):
        atol = EF_ATOL
    paths, leaves, _ = tree_flatten(got)
    for p, a, b in zip(paths, leaves, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   rtol=rtol, err_msg=p)


def _spawn(world, tmp):
    return mp.spawn(torch_ranks_worker.dp, args=(world, str(tmp)),
                    nprocs=world, join=False)


def _wait(ctx):
    while not ctx.join():
        pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)        # leave cores to the spawned ranks
    inputs = {"cases": {}, "moe": {}, "ckpt_case": "qwen3"}
    jax_side = {}
    for name, (arch, ckw, tkw) in CASES.items():
        cfg = dataclasses.replace(TCFG.get_smoke_config(arch), **ckw)
        jcfg = _jcfg(arch, ckw)
        tcfg, jtcfg = _tcfgs(tkw)
        jstate = j_init_state(jcfg, jtcfg, jax.random.PRNGKey(0))
        scfg = j_config_for(jcfg, BATCH, SEQ)
        jbatches = [j_make_batch(scfg, s) for s in range(STEPS)]
        inputs["cases"][name] = {
            "arch": arch, "cfg": ckw, "tcfg": tkw,
            "params": params_from_jax(_np_tree(jstate.params), cfg,
                                      device="cpu"),
            "batches": [{k: torch.from_numpy(np.array(v))
                         for k, v in b.items()} for b in jbatches]}
        jax_side[name] = (jcfg, jtcfg, jstate, jbatches)
    rng = np.random.default_rng(11)
    jcfg = JCFG.get_smoke_config(MOE_ARCH)
    x = rng.standard_normal((8, 32, jcfg.d_model)).astype(np.float32)
    moe_params = _np_tree(j_moe.init_moe(jax.random.PRNGKey(5), jcfg,
                                         jax.numpy.float32))
    inputs["moe"] = {"arch": MOE_ARCH, "x": torch.from_numpy(x),
                     "factors": MOE_FACTORS,
                     "params": {k: torch.from_numpy(v.copy())
                                for k, v in moe_params.items()}}
    tree = {"a": rng.standard_normal((4, 300)).astype(np.float32),
            "b": (rng.standard_normal((4, 7, 40)) * 5).astype(np.float32)}
    inputs["allreduce"] = {k: torch.from_numpy(v) for k, v in tree.items()}
    torch.save(inputs, tmp / "inputs.pt")
    np.savez(tmp / "tree.npz", **tree)

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    j_reduce = subprocess.Popen(
        [sys.executable, "-c", JAX_ALLREDUCE, str(tmp / "tree.npz"),
         str(tmp / "jax_reduced.npz")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ctx = _spawn(2, tmp)

    single, jax_out = {}, {}
    for name, (arch, ckw, tkw) in CASES.items():
        cfg = dataclasses.replace(TCFG.get_smoke_config(arch), **ckw)
        tcfg, _ = _tcfgs(tkw)
        state = init_train_state(cfg, tcfg,
                                 params=inputs["cases"][name]["params"])
        step = make_train_step(cfg, tcfg)
        losses = []
        for b in inputs["cases"][name]["batches"]:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        single[name] = {"losses": losses, "params": state.params}
        jcfg, jtcfg, jstate, jbatches = jax_side[name]
        jstep = jax.jit(j_make_step(jcfg, jtcfg))
        losses = []
        for b in jbatches:
            jstate, jm = jstep(jstate, b)
            losses.append(float(jm["loss"]))
        jax_out[name] = {"losses": losses,
                         "params": jax.tree.leaves(_np_tree(jstate.params))}
    moe_ref = {}
    for f in MOE_FACTORS:
        y, aux = j_moe.moe_block(moe_params, _jcfg(MOE_ARCH,
                                                   {"capacity_factor": f}),
                                 jax.numpy.asarray(x))
        moe_ref[f] = {"y": np.asarray(y), **{k: np.asarray(v)
                                             for k, v in aux.items()}}
    _wait(ctx)
    _wait(_spawn(4, tmp))
    torch.set_num_threads(threads)
    out, err = j_reduce.communicate(timeout=300)
    assert j_reduce.returncode == 0, err[-3000:]
    ranks = {w: [torch.load(tmp / f"out{w}_{r}.pt", weights_only=False)
                 for r in range(w)] for w in WORLDS}
    return {"ranks": ranks, "single": single, "jax": jax_out,
            "moe": moe_ref, "inputs": inputs, "tmp": tmp,
            "jax_reduced": dict(np.load(tmp / "jax_reduced.npz")),
            "tree": tree}


CASE_WORLDS = [(c, w) for c in CASES for w in WORLDS]


@pytest.mark.parametrize("case,world", CASE_WORLDS)
def test_dp_step_equals_single_process(runs, case, world):
    got = runs["ranks"][world][0]["cases"][case]
    want = runs["single"][case]
    np.testing.assert_allclose([float(v) for v in got["losses"]],
                               want["losses"], rtol=1e-5)
    _check_params(case, got["params"], tree_leaves(want["params"]),
                  "single")


@pytest.mark.parametrize("case,world", CASE_WORLDS)
def test_dp_step_equals_jax_on_global_batch(runs, case, world):
    got = runs["ranks"][world][0]["cases"][case]
    want = runs["jax"][case]
    np.testing.assert_allclose([float(v) for v in got["losses"]],
                               want["losses"], rtol=1e-5)
    _check_params(case, got["params"], want["params"], "jax")


@pytest.mark.parametrize("case,world", CASE_WORLDS)
def test_ranks_keep_bitwise_equal_parameters(runs, case, world):
    first = tree_leaves(runs["ranks"][world][0]["cases"][case]["params"])
    for other in runs["ranks"][world][1:]:
        for a, b in zip(first, tree_leaves(other["cases"][case]["params"])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("factor,world", [(f, w) for f in MOE_FACTORS
                                          for w in WORLDS])
def test_moe_global_routing_equals_jax(runs, factor, world):
    """Each rank's rows against JAX's single-device block on the global
    batch: the same pairs dropped (``dropped_frac`` exactly)."""
    want = runs["moe"][factor]
    rows = want["y"].shape[0] // world
    for r, out in enumerate(runs["ranks"][world]):
        got = out["moe"][factor]
        np.testing.assert_allclose(got["y"].numpy(),
                                   want["y"][r * rows:(r + 1) * rows],
                                   atol=1e-5, rtol=0)
        assert float(got["dropped_frac"]) == float(want["dropped_frac"])
        np.testing.assert_allclose(float(got["load_balance_loss"]),
                                   float(want["load_balance_loss"]),
                                   atol=1e-6, rtol=0)
    assert (float(want["dropped_frac"]) > 0.1) == (factor < 1)


def test_allreduce_compressed_equals_jax_on_four_devices(runs):
    for out in runs["ranks"][4]:
        for k, v in out["allreduce"].items():
            np.testing.assert_allclose(v.numpy(), runs["jax_reduced"][k],
                                       atol=1e-6, rtol=0)


def test_allreduce_compressed_is_the_mean_of_the_wire(runs):
    """At world 2: the mean of the two ranks' dequantized blocks, equal
    on both ranks."""
    for k, x in runs["tree"].items():
        wires = [dequantize_int8(*quantize_int8(torch.from_numpy(x[r])),
                                 x[r].shape) for r in range(2)]
        want = (wires[0] + wires[1]) / 2
        for out in runs["ranks"][2]:
            assert torch.equal(out["allreduce"][k], want)


def test_supervised_restart_under_ranks_is_bitwise(runs):
    for out in runs["ranks"][2]:
        sup = out["supervisor"]
        assert sup["restarts"] == 1
        assert sup["sup"] == sup["plain"] and len(sup["plain"]) == 8
        for a, b in zip(tree_leaves(sup["sup_params"]),
                        tree_leaves(sup["plain_params"])):
            assert torch.equal(a, b)


def _saved_state(runs):
    """World 2's checkpoint, read whole."""
    like = runs["ranks"][2][0]["cases"]["qwen3"]["params"]
    cfg = TCFG.get_smoke_config("qwen3-0.6b")
    tcfg, _ = _tcfgs({})
    like = init_train_state(cfg, tcfg, params=like)
    return restore(str(runs["tmp"] / "ckpt"), 3, like)


def test_elastic_restore_two_to_four_is_bitwise(runs):
    """Each of 4 ranks gets its block of every leaf under FSDP specs on
    (4, 1); the blocks are the saved leaves' blocks bit for bit."""
    whole = _saved_state(runs)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(whole.params),
        tree_leaves(runs["ranks"][2][0]["cases"]["qwen3"]["params"])))
    cut = 0
    for r, out in enumerate(runs["ranks"][4]):
        mesh = abstract_mesh((4, 1), ("data", "model"), rank=r)
        got = out["elastic"]["got"]
        for a, full, s in zip(tree_leaves(got), tree_leaves(whole),
                              tree_leaves(out["elastic"]["specs"])):
            assert torch.equal(a, shard_leaf(full, s, mesh))
            cut += a.shape != full.shape
    assert cut > 0


def test_elastic_restore_two_to_one_is_bitwise(runs):
    whole = _saved_state(runs)
    mesh = abstract_mesh((1, 1), ("data", "model"))
    ps = param_pspecs(whole.params, mesh, rules_for_mesh(mesh))
    specs = dataclasses.replace(whole, params=ps,
                                opt=OptState(step=P(), m=ps, v=ps))
    got = restore(str(runs["tmp"] / "ckpt"), 3, whole, mesh=mesh,
                  specs=specs)
    for a, b in zip(tree_leaves(got), tree_leaves(whole)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "moonshot-v1-16b-a3b"])
def test_world_one_step_is_bitwise_the_one_device_step(arch):
    """In-process world of one (gloo): the step with the local mesh's
    constrainer equals the step without it bit for bit."""
    cfg = TCFG.get_smoke_config(arch)
    tcfg, _ = _tcfgs({})
    batches = [make_batch(config_for(cfg, 4, 16), s, device="cpu")
               for s in range(2)]
    init_ranks("cpu")
    try:
        mesh = make_local_mesh()
        constrain = make_constrain(mesh, rules_for_mesh(mesh, fsdp=False), 4)
        states = []
        for c in (constrain, None):
            state = init_train_state(cfg, tcfg,
                                     torch.Generator().manual_seed(0),
                                     device="cpu")
            step = make_train_step(cfg, tcfg, constrain=c)
            for b in batches:
                state, m = step(state, shard_batch(b, mesh, constrain.rules)
                                if c is not None else b)
            states.append(state)
    finally:
        shutdown_ranks()
    assert mesh.shape == {"data": 1, "model": 1} and not constrain.batch_axes
    for a, b in zip(tree_leaves(states[0]), tree_leaves(states[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("world,microbatches", [(2, 1), (2, 2), (4, 2),
                                                (3, 1)])
def test_shard_batch_takes_rows_of_each_microbatch(world, microbatches):
    """Rank r keeps rows [i*B/n + r*B/(n*w), ...) of every microbatch i,
    in order; a world that does not divide the rows replicates them."""
    tokens = torch.arange(24 * 3).reshape(24, 3)
    rules = rules_for_mesh(abstract_mesh((world, 1), ("data", "model")))
    per = 24 // microbatches
    for r in range(world):
        mesh = abstract_mesh((world, 1), ("data", "model"), rank=r)
        got = shard_batch({"tokens": tokens}, mesh, rules,
                          microbatches)["tokens"]
        if per % world:
            assert torch.equal(got, tokens)
            continue
        rows = per // world
        want = torch.cat([tokens[i * per + r * rows:i * per + (r + 1) * rows]
                          for i in range(microbatches)])
        assert torch.equal(got, want)


def test_init_ranks_runs_on_the_card_or_on_cpu_by_request():
    """Without a card, the default (NCCL on the card) raises and starts
    no group, as ``device.resolve_device`` does; other devices are
    refused."""
    import torch.distributed as dist
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_ranks()
    with pytest.raises(ValueError):
        init_ranks("cuda:1")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_ranks"):
        make_local_mesh()
