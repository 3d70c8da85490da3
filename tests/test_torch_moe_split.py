"""MoE and FSDP across ranks on the CPU (gloo), on the paths where the
port used to refuse and JAX runs:

- experts that do not divide the model axis, with the leaves this
  rank's blocks under ``param_pspecs``: on ("data", "model") = (1, 3),
  qwen3-moe-235b-a22b's smoke config (8 experts, ``d_ff`` 96: each model
  rank runs its ``ffn`` columns) and jamba-1.5-large-398b's (4 experts,
  ``d_ff`` 256: whole leaves), against JAX's ``moe_block`` jitted on 3
  fake CPU devices with ``param_pspecs`` shardings (its reference path);
- expert parallelism with the tokens split over batch axes that carry no
  rows: one row on (2, 2) (moonshot-v1-16b-a3b's smoke config through
  ``moe_block``), and two rows on ("pod", "data", "model") = (2, 2, 1)
  (the rows over "pod", the tokens over both; ``moe_block_ep``; and two
  rows of an odd length, whose tokens JAX does not split at all),
  against JAX's ``moe_block_ep`` on 4 fake devices (on the pod mesh,
  JAX's ``ep_context`` answers for its model axis of 1);
- FSDP over ("pod", "data") while the rows split over "pod" alone (and
  over ("data", "pod") on a mesh that lists "data" first, where the
  gathered blocks are put back in JAX's order): qwen3-0.6b's smoke loss
  and gradients against ``jax.grad`` of JAX's ``loss_fn`` on the global
  batch, and against the port's one process.

One spawn of 3 ranks and one of 4 (``torch_ranks_worker.moe_split``)
run the rank side; one JAX subprocess on 4 forced CPU devices runs
JAX's sharded side; the one-process port and JAX's single device run
here meanwhile.

Tolerances (those of ``test_torch_moe_ep.py`` and
``test_torch_train_loss.py``): MoE outputs 1e-5 absolute,
``load_balance_loss`` 1e-6, ``dropped_frac`` exactly; the MoE gradients
against one process 1e-5 absolute and relative; the loss 1e-5
relative; its gradients against JAX 1e-4 absolute / 1e-3 relative, and
against one process 1e-5 absolute and relative.
"""
import dataclasses
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_ranks_worker
from repro import configs as JCFG
from repro.models import model as JM
from repro.models.moe import init_moe as j_init_moe
from repro_torch import configs as TCFG
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import model as M
from repro_torch.models.convert import to_numpy
from repro_torch.models.moe import moe_block
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import tree_flatten, tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DM, PDM, DPM = ("data", "model"), ("pod", "data", "model"), \
    ("data", "pod", "model")
POD = {"batch": ("pod", "data"), "fsdp": ("data",)}
# key: (arch, capacity factor, world, (mesh names, shape), rules,
#       (rows, tokens a row), moe_block_ep called directly, gradients).
# At factor 0.5 enough tokens for pairs to drop past the capacity floor
# of 8; at 64 (the gradients) as many as in test_torch_moe_ep.py, whose
# gradient tolerance they keep.  "pod-odd": 2 rows of an odd length, so
# the 2 x 63 tokens do not split over the 4 ranks of ("pod", "data"):
# JAX routes every token on every device, the port each rank's row with
# the whole batch's queues.
MOE = {
    "ffn-64": ("qwen3-moe-235b-a22b", 64.0, 3, (DM, (1, 3)), {}, (2, 64),
               False, True),
    "ffn-0.5": ("qwen3-moe-235b-a22b", 0.5, 3, (DM, (1, 3)), {}, (2, 256),
                False, False),
    "whole-64": ("jamba-1.5-large-398b", 64.0, 3, (DM, (1, 3)), {}, (2, 64),
                 False, True),
    "whole-0.5": ("jamba-1.5-large-398b", 0.5, 3, (DM, (1, 3)), {},
                  (2, 256), False, False),
    "tokens-64": ("moonshot-v1-16b-a3b", 64.0, 4, (DM, (2, 2)), {}, (1, 64),
                  False, True),
    "tokens-0.5": ("moonshot-v1-16b-a3b", 0.5, 4, (DM, (2, 2)), {},
                   (1, 256), False, False),
    "pod-64": ("moonshot-v1-16b-a3b", 64.0, 4, (PDM, (2, 2, 1)), POD,
               (2, 64), True, False),
    "pod-0.5": ("moonshot-v1-16b-a3b", 0.5, 4, (PDM, (2, 2, 1)), POD,
                (2, 256), True, False),
    "pod-odd-0.5": ("moonshot-v1-16b-a3b", 0.5, 4, (PDM, (2, 2, 1)), POD,
                    (2, 255), True, False),
}
# key: ((mesh names, shape), rules)
LOSS = {
    "fsdp-pod-data": ((PDM, (2, 2, 1)), {"batch": ("pod", "data"),
                                         "fsdp": ("pod", "data")}),
    "fsdp-data-pod": ((DPM, (2, 2, 1)), {"batch": ("pod", "data"),
                                         "fsdp": ("data", "pod")}),
}
LOSS_SEQ, LOSS_ARCH, LOSS_BATCH = 16, "qwen3-0.6b", 2
RANKS_TIMEOUT = 300             # seconds for the spawned ranks

JAX_SIDE = """
import dataclasses, math, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh, NamedSharding
from repro import configs as JCFG
from repro.models.moe import moe_block, moe_block_ep
from repro.sharding.rules import ShardingRules, make_constrain, param_pspecs
assert len(jax.devices()) == 4, jax.devices()
cases = eval(sys.argv[1])
z = np.load(sys.argv[2])
out = {}
for key, (arch, factor, names, shape, rules_kw, ep) in cases.items():
    cfg = dataclasses.replace(JCFG.get_smoke_config(arch),
                              capacity_factor=factor)
    devs = np.array(jax.devices()[:math.prod(shape)]).reshape(shape)
    mesh = Mesh(devs, names, axis_types=(AxisType.Auto,) * len(names))
    rules = ShardingRules(**rules_kw)
    params = {k: jnp.asarray(z[f"{key}/{k}"])
              for k in ("router", "gate", "up", "down")}
    x = jnp.asarray(z[f"{key}/x"])
    cns = make_constrain(mesh, rules, x.shape[0])
    if ep and mesh.shape[rules.model] == 1:
        # JAX's EP asks ep_context for its mesh; it answers None at a
        # model axis of 1
        cns.ep_context = lambda: (mesh, rules.batch, 1)
    specs = param_pspecs(params, mesh, rules)
    shard = {k: NamedSharding(mesh, specs[k]) for k in params}
    if ep:
        fn = lambda p, v: moe_block_ep(p, cfg, v, cns)
    else:
        fn = lambda p, v: moe_block(p, cfg, v, constrain=cns)
    with mesh:
        y, aux = jax.jit(fn)(jax.device_put(params, shard), x)
    out[key + "/y"] = np.asarray(y)
    for k, v in aux.items():
        out[key + "/" + k] = np.asarray(v)
np.savez(sys.argv[3], **out)
"""


def _cfg(arch, factor):
    return dataclasses.replace(TCFG.get_smoke_config(arch),
                               capacity_factor=factor)


def _one_process_grads(params, cfg, x, r):
    live = {k: p.clone().requires_grad_(True) for k, p in params.items()}
    xg = x.clone().requires_grad_(True)
    y, aux = moe_block(live, cfg, xg)
    ((y * r).sum() + 0.01 * aux["load_balance_loss"]).backward()
    return {k: p.grad for k, p in live.items()}, xg.grad


def _loss_batch(cfg):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (LOSS_BATCH, LOSS_SEQ)).astype(
        np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_split")
    rng = np.random.default_rng(1)
    cases, npz, jax_cases = {}, {}, {}
    for i, (key, (arch, factor, world, (names, shape), rules, (rows, seq),
                  ep, grad)) in enumerate(MOE.items()):
        jcfg = JCFG.get_smoke_config(arch)
        params = jax.tree.map(np.asarray, j_init_moe(
            jax.random.PRNGKey(i), jcfg, jnp.float32))
        x = rng.standard_normal((rows, seq, jcfg.d_model)).astype(
            np.float32)
        r = rng.standard_normal(x.shape).astype(np.float32)
        npz.update({f"{key}/{k}": v for k, v in params.items()})
        npz[f"{key}/x"] = x
        cases[key] = {"kind": "moe", "arch": arch, "world": world,
                      "mesh": (names, shape), "rules": rules,
                      "cfg": {"capacity_factor": factor}, "ep": ep,
                      "params": {k: torch.from_numpy(v.copy())
                                 for k, v in params.items()},
                      "x": torch.from_numpy(x),
                      "r": torch.from_numpy(r) if grad else None}
        jax_cases[key] = (arch, factor, names, shape, rules, ep)
    cfg = TCFG.get_smoke_config(LOSS_ARCH)
    params = M.init_params(cfg, torch.Generator().manual_seed(5),
                           device="cpu")
    batch = _loss_batch(cfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for key, ((names, shape), rules) in LOSS.items():
        cases[key] = {"kind": "loss", "arch": LOSS_ARCH, "world": 4,
                      "mesh": (names, shape), "rules": rules,
                      "params": params, "batch": tbatch}
    torch.save({"cases": cases}, tmp / "inputs.pt")
    np.savez(tmp / "in.npz", **npz)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, repr(jax_cases), str(tmp / "in.npz"),
         str(tmp / "jax.npz")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # leave cores to the spawned ranks
    ctxs = [mp.spawn(torch_ranks_worker.moe_split, args=(w, str(tmp)),
                     nprocs=w, join=False) for w in (3, 4)]
    single = {key: _one_process_grads(
        cases[key]["params"], _cfg(MOE[key][0], MOE[key][1]),
        cases[key]["x"], cases[key]["r"])
        for key in MOE if cases[key]["r"] is not None}
    loss, _, grads = loss_and_grads(params, cfg, tbatch)
    jcfg = JCFG.get_smoke_config(LOSS_ARCH)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, batch), has_aux=True)(
            jax.tree.map(jnp.asarray, to_numpy(params)))
    deadline = time.monotonic() + RANKS_TIMEOUT
    for ctx in ctxs:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the ranks did not finish"
    torch.set_num_threads(threads)
    _, err = jax_run.communicate(timeout=300)
    assert jax_run.returncode == 0, err[-3000:]
    z = np.load(tmp / "jax.npz")
    ranks = {w: [torch.load(tmp / f"out{w}_{r}.pt", weights_only=False)
                 for r in range(w)] for w in (3, 4)}
    return {"ranks": ranks, "jax": {k: z[k] for k in z.files},
            "single": single, "cases": cases,
            "loss": {"single": (float(loss), grads),
                     "jax": (float(jloss), jax.tree.map(np.asarray,
                                                        jgrads))}}


def _rows_of(ranks_rows, rank, names, shape, b):
    """The global rows [lo, hi) a rank holds (its rows' axes row-major)."""
    if not ranks_rows:
        return 0, b
    at = abstract_mesh(shape, names, rank)
    n, i = at.axis_size(ranks_rows), at.axis_index(ranks_rows)
    return i * b // n, (i + 1) * b // n


@pytest.mark.parametrize("key", list(MOE))
def test_moe_equals_jax(runs, key):
    """Each rank's rows of the output, the load-balance loss and
    ``dropped_frac``, against JAX's on the same mesh of fake devices."""
    arch, factor, world, (names, shape), *_ = MOE[key]
    jy = runs["jax"][key + "/y"]
    for rank, out in enumerate(runs["ranks"][world]):
        got = out[key]
        lo, hi = _rows_of(got["rows"], rank, names, shape, jy.shape[0])
        np.testing.assert_allclose(got["y"].numpy(), jy[lo:hi], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(float(got["load_balance_loss"]), float(
            runs["jax"][key + "/load_balance_loss"]), atol=1e-6, rtol=0)
        assert float(got["dropped_frac"]) == float(
            runs["jax"][key + "/dropped_frac"])
    dropped = float(runs["jax"][key + "/dropped_frac"])
    assert (dropped > 0.05) == (factor < 1), dropped


def test_routes_are_the_ones_named(runs):
    """qwen3-moe's 8 experts do not divide 3 while its ``d_ff`` 96 does;
    jamba's 4 experts and ``d_ff`` 256 divide neither; moonshot's 8
    experts divide 2; the one-row and two-row cases hold their rows as
    named (none; "pod" alone)."""
    for arch, e, cut in (("qwen3-moe-235b-a22b", 8, True),
                         ("jamba-1.5-large-398b", 4, False)):
        cfg = TCFG.get_smoke_config(arch)
        assert cfg.num_experts == e and cfg.num_experts % 3
        assert (cfg.d_ff % 3 == 0) == cut
    assert runs["ranks"][4][0]["tokens-64"]["rows"] == ()
    assert runs["ranks"][4][0]["pod-64"]["rows"] == ("pod",)
    assert runs["ranks"][4][0]["pod-odd-0.5"]["rows"] == ("pod",)


@pytest.mark.parametrize("key", [k for k in MOE if MOE[k][7]])
def test_moe_gradients_equal_one_process(runs, key):
    """Every rank's gradients of every leaf (gathered whole) and of x
    against ``moe_block`` in one process."""
    want, want_x = runs["single"][key]
    world = MOE[key][2]
    for out in runs["ranks"][world]:
        got = out[key]
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want[k].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["x_grad"].numpy(), want_x.numpy(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("key", list(LOSS))
def test_fsdp_over_partly_row_axes_equals_jax(runs, key):
    """The loss and every gradient leaf (gathered whole) with the FSDP
    dims over ("pod", "data") while the rows split over "pod" alone,
    against ``jax.grad`` on the global batch and the port's one
    process."""
    jloss, jgrads = runs["loss"]["jax"]
    loss, grads = runs["loss"]["single"]
    paths, want, _ = tree_flatten(grads)
    jwant = jax.tree.leaves(jgrads)
    for out in runs["ranks"][4]:
        got = out[key]
        assert got["rows"] == ("pod",)
        np.testing.assert_allclose(float(got["loss"]), jloss, rtol=1e-5)
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5)
        for p, g, w, jw in zip(paths, tree_leaves(got["grads"]), want,
                               jwant):
            np.testing.assert_allclose(g.numpy(), jw, atol=1e-4, rtol=1e-3,
                                       err_msg=p)
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=p)
