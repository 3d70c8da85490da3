"""Expert parallelism on the CPU (gloo): the port's ``moe_block`` on a
(2, 2) ("data", "model") mesh of 4 ranks, where it takes the EP path,
against JAX's ``moe_block`` on the same mesh of 4 fake devices (its
``shard_map`` EP, in a subprocess with ``JAX_PLATFORMS=cpu``), at a
capacity factor of 64 and at 0.5 (which drops pairs), with
``expert_fsdp`` on and off.  JAX's gradient through EP raises on this
jax, so the port's EP gradient is held against the port's one-process
``moe_block`` gradient at factor 64.  Each rank holds its blocks of the
parameters under ``param_pspecs`` (``shard_leaf``).

Tolerances: output 1e-5, ``load_balance_loss`` 1e-6, ``dropped_frac``
exactly; gradients 1e-5 absolute and relative (f32 sums
over ranks and pairs in another order); one rank's EP equals
``moe_block`` bit for bit.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_ranks_worker
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import uniform_pattern as j_uniform_pattern
from repro.models.moe import init_moe as j_init_moe
from repro_torch.launch.mesh import (abstract_mesh, init_ranks, make_mesh,
                                     shutdown_ranks)
from repro_torch.models.config import ModelConfig, uniform_pattern
from repro_torch.models.moe import init_moe, moe_block, moe_block_ep
from repro_torch.sharding.rules import (ShardingRules, make_constrain,
                                        param_pspecs, shard_leaf)
from repro_torch.train import TrainConfig, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
CFG = dict(name="m", num_layers=1, d_model=32, num_heads=2, num_kv_heads=2,
           head_dim=16, d_ff=48, vocab_size=11, num_experts=8,
           num_experts_per_tok=2, capacity_factor=64.0, dtype="float32")
# key: (capacity factor, expert_fsdp, gradient)
VARIANTS = {f"{f}-{'fsdp' if fs else 'nofsdp'}{'-grad' if g else ''}":
            {"factor": f, "expert_fsdp": fs, "grad": g}
            for f, fs, g in [(64.0, True, False), (64.0, False, False),
                             (0.5, True, False), (0.5, False, False),
                             (64.0, True, True), (64.0, False, True)]}
FWD = [k for k, v in VARIANTS.items() if not v["grad"]]
GRAD = [k for k, v in VARIANTS.items() if v["grad"]]

JAX_EP = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.models.config import ModelConfig, uniform_pattern
from repro.models.moe import moe_block
from repro.sharding.rules import ShardingRules, make_constrain
kw = eval(sys.argv[1])
z = np.load(sys.argv[2])
params = {k: jnp.asarray(z[k]) for k in ("router", "gate", "up", "down")}
x = jnp.asarray(z["x"])
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for factor in (64.0, 0.5):
    cfg = ModelConfig(pattern=uniform_pattern(moe=True),
                      **dict(kw, capacity_factor=factor))
    for fs in (True, False):
        rules = ShardingRules(batch=("data",), fsdp=("data",),
                              expert_fsdp=fs)
        cns = make_constrain(mesh, rules, x.shape[0])
        with mesh:
            y, aux = jax.jit(lambda p, v: moe_block(p, cfg, v,
                                                    constrain=cns))(params, x)
        key = f"{factor}-{'fsdp' if fs else 'nofsdp'}"
        out[key + "/y"] = np.asarray(y)
        for k, v in aux.items():
            out[key + "/" + k] = np.asarray(v)
np.savez(sys.argv[3], **out)
"""


def _cfg(factor=64.0):
    return ModelConfig(pattern=uniform_pattern(moe=True),
                       **dict(CFG, capacity_factor=factor))


def _single_grads(params, x, r):
    """The one-process ``moe_block`` gradients of sum(y * r) + 0.01 * lb."""
    live = {k: p.clone().requires_grad_(True) for k, p in params.items()}
    xg = x.clone().requires_grad_(True)
    y, aux = moe_block(live, _cfg(), xg)
    ((y * r).sum() + 0.01 * aux["load_balance_loss"]).backward()
    return {k: p.grad for k, p in live.items()}, xg.grad


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    jcfg = JModelConfig(pattern=j_uniform_pattern(moe=True), **CFG)
    params = jax.tree.map(np.asarray, j_init_moe(jax.random.PRNGKey(0),
                                                 jcfg, jnp.float32))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 64, 32)).astype(np.float32)
    r = rng.standard_normal((4, 64, 32)).astype(np.float32)
    np.savez(tmp / "in.npz", x=x, **params)
    inputs = {"cfg": CFG, "x": torch.from_numpy(x),
              "r": torch.from_numpy(r), "variants": VARIANTS,
              "params": {k: torch.from_numpy(v.copy())
                         for k, v in params.items()}}
    torch.save(inputs, tmp / "inputs.pt")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_EP, repr(CFG), str(tmp / "in.npz"),
         str(tmp / "jax.npz")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ctx = mp.spawn(torch_ranks_worker.ep, args=(WORLD, str(tmp)),
                   nprocs=WORLD, join=False)
    grads = _single_grads(inputs["params"], inputs["x"], inputs["r"])
    while not ctx.join():
        pass
    _, err = jax_run.communicate(timeout=300)
    assert jax_run.returncode == 0, err[-3000:]
    z = np.load(tmp / "jax.npz")
    return {"ranks": [torch.load(tmp / f"out{WORLD}_{i}.pt",
                                 weights_only=False) for i in range(WORLD)],
            "jax": {k: z[k] for k in z.files}, "single": grads}


@pytest.mark.parametrize("key", FWD)
def test_ep_forward_equals_jax_ep(runs, key):
    jax_y = runs["jax"][key + "/y"]
    rows = jax_y.shape[0] // 2
    for rank, out in enumerate(runs["ranks"]):
        d = abstract_mesh((2, 2), ("data", "model"), rank).axis_index("data")
        got = out["fwd"][key]
        np.testing.assert_allclose(got["y"].numpy(),
                                   jax_y[d * rows:(d + 1) * rows],
                                   atol=1e-5, rtol=0)
        assert float(got["dropped_frac"]) == float(
            runs["jax"][key + "/dropped_frac"])
        np.testing.assert_allclose(float(got["load_balance_loss"]),
                                   float(runs["jax"][key +
                                                     "/load_balance_loss"]),
                                   atol=1e-6, rtol=0)
    dropped = float(runs["jax"][key + "/dropped_frac"])
    assert (dropped > 0.05) == (VARIANTS[key]["factor"] < 1), dropped


@pytest.mark.parametrize("key", GRAD)
def test_ep_gradient_equals_one_process_gradient(runs, key):
    """Each rank's block of every leaf's gradient, and of its rows'."""
    want, want_x = runs["single"]
    rows = want_x.shape[0] // 2
    for rank, out in enumerate(runs["ranks"]):
        mesh = abstract_mesh((2, 2), ("data", "model"), rank)
        got = out["grad"][key]
        for k, g in got["params"].items():
            np.testing.assert_allclose(
                g.numpy(), shard_leaf(want[k], got["specs"][k], mesh).numpy(),
                atol=1e-5, rtol=1e-5, err_msg=k)
        d = mesh.axis_index("data")
        np.testing.assert_allclose(got["x"].numpy(),
                                   want_x[d * rows:(d + 1) * rows].numpy(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("factor", [64.0, 0.5])
def test_ep_on_one_rank_is_moe_block(factor):
    """In-process world of one: a (1, 1) mesh's EP equals the plain block
    bit for bit (JAX: "on a 1-device mesh the two paths are
    identical")."""
    cfg = _cfg(factor)
    gen = torch.Generator().manual_seed(3)
    params = init_moe(gen, cfg, torch.float32)
    x = torch.randn((4, 64, 32), generator=gen)
    init_ranks("cpu")
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        constrain = make_constrain(mesh, ShardingRules(), 4)
        assert constrain.ep_context() is None
        y, aux = moe_block_ep(params, cfg, x, constrain)
    finally:
        shutdown_ranks()
    want, want_aux = moe_block(params, cfg, x)
    assert torch.equal(y, want)
    for k in aux:
        assert torch.equal(aux[k], want_aux[k]), k


def test_ep_context_and_training_under_a_model_axis():
    """``ep_context`` is JAX's (None at a model axis of 1); training with
    a model axis larger than 1 is taken (tensor and expert parallelism at
    run time), and so is int8 error feedback on sharded leaves
    (``test_torch_ef_sharded.py`` holds it against the whole leaves)."""
    rules = ShardingRules()
    mesh = abstract_mesh((2, 4), ("data", "model"))
    wide = make_constrain(mesh, rules, 8)
    assert wide.ep_context()[1:] == (("data",), 4)
    assert wide.batch_axes == ("data",)
    flat = make_constrain(abstract_mesh((8, 1), ("data", "model")), rules, 4)
    assert flat.ep_context() is None and flat.batch_axes == ()
    assert callable(make_train_step(_cfg(), TrainConfig(), constrain=wide))
    specs = param_pspecs({"gate": torch.empty(8, 32, 48)}, mesh, rules)
    assert callable(make_train_step(
        _cfg(), TrainConfig(pod_compression=True),
        constrain=make_constrain(mesh, rules, 8, specs)))


def test_expert_leaves_follow_param_pspecs():
    """The blocks ``moe_block_ep`` expects: experts over "model", the
    FSDP dim over "data" with ``expert_fsdp``, the router's experts over
    "model"."""
    mesh = abstract_mesh((2, 2), ("data", "model"))
    shapes = {"router": torch.empty(32, 8), "gate": torch.empty(8, 32, 48),
              "up": torch.empty(8, 32, 48), "down": torch.empty(8, 48, 32)}
    on = param_pspecs(shapes, mesh, ShardingRules(batch=("data",)))
    off = param_pspecs(shapes, mesh, ShardingRules(batch=("data",),
                                                   expert_fsdp=False))
    assert tuple(on["gate"]) == ("model", "data", None)
    assert tuple(on["down"]) == ("model", None, "data")
    assert tuple(off["gate"]) == ("model", None, None)
    assert tuple(on["router"]) == tuple(off["router"]) == (None, "model")
