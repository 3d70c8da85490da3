"""Int8 error feedback on sharded leaves on the CPU (gloo): the port's
``ef_compress_tree(..., mesh=, specs=)`` on each rank's blocks against
the whole-leaf round on the global gradients, leaf by leaf, and against
JAX's ``ef_compress_tree``; the train step with ``pod_compression`` on
sharded parameters against one process, and across a sharded save and
restore.

One spawn of 4 ranks (meshes (4, 1), (1, 4) and (2, 2)) and one of 2
((2, 1), (1, 2)) run ``torch_ranks_worker.ef_sharded``.  The gradients
are seeded NumPy draws shaped like moonshot-v1-16b-a3b's smoke
parameters (attention, router, the [E, D, F] experts, embedding and
head), in f32 and in bf16, with f32 error buffers; ``param_pspecs``
under ``rules_for_mesh`` (FSDP over "data", tensor and expert
parallelism over "model") cut them, so a rank's block is not a run of
whole 256-blocks of the global leaf.

Tolerances: the wire and the new error buffer equal the whole-leaf
round's rank by rank bit for bit, and JAX's int8 payloads, scales,
wire and error buffers exactly (every step is an IEEE operation on the
same f32 values); the train step's losses 1e-5 relative of one
process's, its parameters within 1e-4 absolute (``test_torch_dp.py``'s
``EF_ATOL``: an element within rounding of an int8 half-step can round
the other way); a step after a sharded save and restore bit for bit
the uninterrupted step.
"""
import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_ranks_worker
from repro.train import compression as jcomp
from repro_torch import configs as TCFG
from repro_torch.data.synthetic import config_for, make_batch
from repro_torch.launch.mesh import abstract_mesh, rules_for_mesh
from repro_torch.models import model as M
from repro_torch.models.convert import to_numpy
from repro_torch.sharding.rules import param_pspecs, spec_axes
from repro_torch.train import (AdamWConfig, TrainConfig, init_train_state,
                               make_train_step)
from repro_torch.train.compression import ef_compress_tree, quantize_int8
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

MESHES = {4: {"fsdp": (4, 1), "tp": (1, 4), "both": (2, 2)},
          2: {"fsdp2": (2, 1), "tp2": (1, 2)}}
CASES = ("f32", "bf16")
GRAD_ARCH, TRAIN_ARCH = "moonshot-v1-16b-a3b", "qwen3-0.6b"
TRAIN_MESH, BATCH, SEQ, STEPS = (2, 2), 8, 16, 3
EF_ATOL = 1e-4
RANKS_TIMEOUT = 300             # seconds for the spawned ranks


def _draws(like, seed, scale):
    rng = np.random.default_rng(seed)
    return tree_map(lambda p: torch.from_numpy(
        (scale * rng.standard_normal(tuple(p.shape))).astype(np.float32)),
        like)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ef_sharded")
    like = M.init_params(TCFG.get_smoke_config(GRAD_ARCH),
                         torch.Generator().manual_seed(0), device="cpu")
    grads = _draws(like, 1, 1.0)
    cfg = TCFG.get_smoke_config(TRAIN_ARCH)
    params = M.init_params(cfg, torch.Generator().manual_seed(2),
                           device="cpu")
    scfg = config_for(cfg, BATCH, SEQ)
    batches = [make_batch(scfg, s, device="cpu") for s in range(STEPS)]
    inputs = {"meshes": MESHES, "error": _draws(like, 3, 1e-2),
              "grads": {"f32": grads, "bf16": tree_map(
                  lambda g: g.to(torch.bfloat16), grads)},
              "train": {"arch": TRAIN_ARCH, "mesh": TRAIN_MESH,
                        "params": params, "batches": batches}}
    torch.save(inputs, tmp / "inputs.pt")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # leave cores to the spawned ranks
    ctxs = [mp.spawn(torch_ranks_worker.ef_sharded, args=(w, str(tmp)),
                     nprocs=w, join=False) for w in MESHES]
    tcfg = TrainConfig(opt=AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                       total_steps=10), pod_compression=True)
    state = init_train_state(cfg, tcfg, params=params)
    step = make_train_step(cfg, tcfg)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    deadline = time.monotonic() + RANKS_TIMEOUT
    for ctx in ctxs:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the ranks did not finish"
    torch.set_num_threads(threads)
    ranks = {w: [torch.load(tmp / f"out{w}_{r}.pt", weights_only=False)
                 for r in range(w)] for w in MESHES}
    return {"inputs": inputs, "ranks": ranks,
            "single": {"losses": losses, "state": state}}


EF_CASES = [(w, m, c) for w in MESHES for m in MESHES[w] for c in CASES]


@pytest.mark.parametrize("world,mesh,case", EF_CASES)
def test_sharded_round_equals_the_whole_leaf_round(runs, world, mesh, case):
    """Every rank's gathered wire and new error buffer, leaf by leaf,
    bit for bit the whole-leaf round's; and some leaf is cut on the
    mesh."""
    grads, error = runs["inputs"]["grads"][case], runs["inputs"]["error"]
    want = ef_compress_tree(grads, error)
    paths = tree_flatten(grads)[0]
    at = abstract_mesh(MESHES[world][mesh], ("data", "model"))
    specs = tree_leaves(param_pspecs(grads, at, rules_for_mesh(at)))
    # some leaf's blocks are not runs of whole 256-blocks of the leaf
    assert any(spec_axes(s, at) and g.shape[-1] % 256
               for s, g in zip(specs, tree_leaves(grads)))
    for out in runs["ranks"][world]:
        got = out["ef"][mesh, case]
        for part, w_tree, g_tree in zip(("wire", "error"), want, got):
            for p, a, b in zip(paths, tree_leaves(g_tree),
                               tree_leaves(w_tree)):
                assert a.dtype == b.dtype == torch.float32, (part, p)
                assert torch.equal(a, b), (part, p)


@pytest.mark.parametrize("case", CASES)
def test_whole_leaf_round_equals_jax(runs, case):
    """The round the sharded one equals, against JAX's on the same
    gradients and error buffers: int8 payloads and scales, the wire and
    the new error buffers exactly."""
    grads, error = runs["inputs"]["grads"][case], runs["inputs"]["error"]
    wire, err = ef_compress_tree(grads, error)
    jg, je = to_numpy(grads), to_numpy(error)
    jwire, jerr = jcomp.ef_compress_tree(
        tree_map(jnp.asarray, jg), tree_map(jnp.asarray, je))
    for g, e, w, r, jw, jr in zip(*(tree_leaves(t) for t in (
            grads, error, wire, err, jwire, jerr))):
        q, s, _ = quantize_int8(g.to(torch.float32) + e)
        jq, js, _ = jcomp.quantize_int8(jnp.asarray(
            to_numpy(g)).astype(jnp.float32) + jnp.asarray(e.numpy()))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


def test_ef_step_on_sharded_leaves_equals_one_process(runs):
    """3 steps with ``pod_compression`` on (2, 2) blocks (FSDP, tensor
    parallelism): the losses and the parameters of one process."""
    got = runs["ranks"][4][0]["train"]
    want = runs["single"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for out in runs["ranks"][4][1:]:
        assert out["train"]["losses"] == got["losses"]
    for a, b in zip(tree_leaves(got["state"].params),
                    tree_leaves(want["state"].params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=EF_ATOL,
                                   rtol=0)
    assert any(float(e.abs().max()) > 0
               for e in tree_leaves(got["state"].ef_error))


def test_sharded_save_restore_and_step_is_bitwise(runs):
    """The third step after a sharded save and restore of the state,
    error buffers included, equals the uninterrupted third step bit for
    bit, on every rank."""
    for out in runs["ranks"][4]:
        res = out["train"]
        a, b = tree_leaves(res["resumed"]), tree_leaves(res["state"])
        assert len(a) == len(b) and dataclasses.is_dataclass(res["state"])
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)
