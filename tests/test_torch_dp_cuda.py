"""Ranks on CUDA cards with NCCL: at world 1 (a one-rank group in this
process) the data-parallel train step, and the step with FSDP rules on
the (1, 1) mesh, equal the one-device step bit for bit, as do the step
and the prefill with ``sp`` rules and greedy decode through
``decode_step(constrain=)`` on ``init_cache(constrain=)``'s caches,
``allreduce_compressed`` equals its plain form bit for bit, and a (1, 1)
mesh's expert parallelism equals ``moe_block`` bit for bit; with
two or more cards, a run across all of them (``torch_ranks_worker.cards``,
spawned) against one card.

Every test here needs the card (marker ``cuda``) and skips without one;
the across-cards test also skips with fewer than two.  The file imports
neither JAX nor the JAX package:

    PYTHONPATH=src:tests python -m pytest -q -m cuda tests/test_torch_dp_cuda.py

Tolerances: across cards, losses 1e-5 relative after 3 f32 steps;
parameters 1e-4 absolute, 1e-5 relative: the sums over ranks add in
another order, and where an element's gradient is at the level of that
rounding AdamW (lr 3e-3) moves it by a different step (on 4 cards one
element of 24,576 parted by 2.3e-5); ranks' parameters bitwise equal;
the EP block's output 1e-5 and ``dropped_frac`` exactly.
"""
import dataclasses

import pytest
import torch
import torch.multiprocessing as mp

import torch_ranks_worker
from repro_torch import configs as CFG
from repro_torch.data.synthetic import config_for, make_batch, shard_batch
from repro_torch.launch.mesh import (init_ranks, make_local_mesh, make_mesh,
                                     rules_for_mesh, shutdown_ranks)
from repro_torch.launch.train import train
from repro_torch.models.moe import init_moe, moe_block, moe_block_ep
from repro_torch.models import model as M
from repro_torch.models.model import init_params
from repro_torch.sharding.rules import (ShardingRules, make_constrain,
                                        param_pspecs, shard_leaf)
from repro_torch.train import (AdamWConfig, TrainConfig, init_train_state,
                               make_train_step)
from repro_torch.train.compression import (allreduce_compressed,
                                           dequantize_int8, quantize_int8)
from repro_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the CUDA kernels have "
                    "no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def nccl_world_one(cuda):
    init_ranks()
    try:
        yield make_local_mesh()
    finally:
        shutdown_ranks()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "moonshot-v1-16b-a3b"])
def test_world_one_step_is_the_one_device_step(nccl_world_one, arch):
    mesh = nccl_world_one
    cfg = CFG.get_smoke_config(arch)
    tcfg = TrainConfig(opt=AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                       total_steps=10))
    constrain = make_constrain(mesh, rules_for_mesh(mesh, fsdp=False), 4)
    batches = [make_batch(config_for(cfg, 4, 64), s) for s in range(2)]
    states = []
    for c in (constrain, None):
        state = init_train_state(cfg, tcfg, torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        step = make_train_step(cfg, tcfg, constrain=c)
        for b in batches:
            state, _ = step(state, b if c is None else shard_batch(
                b, mesh, c.rules))
        states.append(state)
    for a, b in zip(tree_leaves(states[0]), tree_leaves(states[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b",
                                  "moonshot-v1-16b-a3b"])
def test_world_one_fsdp_step_is_the_one_device_step(nccl_world_one, arch):
    """FSDP rules (``rules_for_mesh``'s default) on the (1, 1) mesh: the
    state is cut by ``param_pspecs`` and the step runs the sharded path,
    and every axis has size 1, so it equals the unsharded step bit for
    bit."""
    mesh = nccl_world_one
    cfg = CFG.get_smoke_config(arch)
    tcfg = TrainConfig(opt=AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                       total_steps=10))
    rules = rules_for_mesh(mesh)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    specs = param_pspecs(params, mesh, rules)
    assert rules.fsdp == ("data",) and any(
        "data" in tuple(s) for s in tree_leaves(specs))
    constrain = make_constrain(mesh, rules, 4, param_specs=specs)
    batches = [make_batch(config_for(cfg, 4, 64), s) for s in range(2)]
    states = []
    for c in (constrain, None):
        mine = params if c is None else tree_map(
            lambda p, s: shard_leaf(p, s, mesh), params, specs)
        state = init_train_state(cfg, tcfg, params=mine)
        step = make_train_step(cfg, tcfg, constrain=c)
        for b in batches:
            state, _ = step(state, b if c is None else shard_batch(
                b, mesh, c.rules))
        states.append(state)
    for a, b in zip(tree_leaves(states[0]), tree_leaves(states[1])):
        assert torch.equal(a, b)


def test_world_one_allreduce_compressed_is_its_plain_form(nccl_world_one):
    gen = torch.Generator(device="cuda").manual_seed(1)
    tree = {"a": torch.randn((3000,), generator=gen, device="cuda"),
            "b": torch.randn((7, 300), generator=gen, device="cuda")}
    got = allreduce_compressed(nccl_world_one, "data", tree)
    for k, x in tree.items():
        assert torch.equal(got[k], dequantize_int8(*quantize_int8(x),
                                                   x.shape) / 1)


@pytest.mark.parametrize("factor", [64.0, 0.5])
def test_world_one_ep_is_moe_block(nccl_world_one, factor):
    cfg = dataclasses.replace(CFG.get_smoke_config("moonshot-v1-16b-a3b"),
                              capacity_factor=factor)
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = init_moe(gen, cfg, torch.float32)
    x = torch.randn((4, 256, cfg.d_model), generator=gen, device="cuda")
    mesh = make_mesh((1, 1), ("data", "model"))
    y, aux = moe_block_ep(params, cfg, x,
                          make_constrain(mesh, ShardingRules(), 4))
    want, want_aux = moe_block(params, cfg, x)
    assert torch.equal(y, want)
    for k in aux:
        assert torch.equal(aux[k], want_aux[k]), k


def test_across_cards_equals_one_card(cuda, tmp_path):
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip(f"needs two or more cards, the machine shows {world}")
    cfg = CFG.get_smoke_config("moonshot-v1-16b-a3b")
    gen = torch.Generator().manual_seed(4)
    moe = init_moe(gen, cfg, torch.float32)
    x = torch.randn((4, 64, cfg.d_model), generator=gen)
    torch.save({"moe": moe, "x": x}, tmp_path / "inputs.pt")
    mp.spawn(torch_ranks_worker.cards, args=(world, str(tmp_path)),
             nprocs=world)
    outs = [torch.load(tmp_path / f"out{world}_{r}.pt", weights_only=False)
            for r in range(world)]
    one = train(CFG.get_smoke_config("qwen3-0.6b"), steps=3, batch=8,
                seq=64, device="cuda", log=lambda line: None)
    want_y, want_aux = moe_block({k: v.cuda() for k, v in moe.items()},
                                 cfg, x.cuda())
    for out in outs:
        torch.testing.assert_close(torch.tensor(out["losses"]),
                                   torch.tensor(one.losses), rtol=1e-5,
                                   atol=0)
        for a, b in zip(tree_leaves(out["params"]),
                        tree_leaves(one.state.params)):
            torch.testing.assert_close(a, b.cpu(), rtol=1e-5, atol=1e-4)
        for a, b in zip(tree_leaves(out["params"]),
                        tree_leaves(outs[0]["params"])):
            assert torch.equal(a, b)
        torch.testing.assert_close(out["y"], want_y.cpu(), rtol=0,
                                   atol=1e-5)
        assert float(out["aux"]["dropped_frac"]) == float(
            want_aux["dropped_frac"])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b",
                                  "moonshot-v1-16b-a3b"])
def test_world_one_sp_step_and_prefill_are_the_one_device_ones(
        nccl_world_one, arch):
    """``sp`` rules (with FSDP) on the (1, 1) mesh: the model axis is 1,
    so the sequence is not split and the step and the prefill equal the
    unsharded ones bit for bit."""
    mesh = nccl_world_one
    cfg = CFG.get_smoke_config(arch)
    tcfg = TrainConfig(opt=AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                       total_steps=10))
    rules = rules_for_mesh(mesh, sp=True)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    specs = param_pspecs(params, mesh, rules)
    constrain = make_constrain(mesh, rules, 4, param_specs=specs)
    assert constrain.seq(64) is None
    batches = [make_batch(config_for(cfg, 4, 64), s) for s in range(2)]
    states = []
    for c in (constrain, None):
        state = init_train_state(cfg, tcfg, params=params)
        step = make_train_step(cfg, tcfg, constrain=c)
        for b in batches:
            state, _ = step(state, b if c is None else shard_batch(
                b, mesh, c.rules))
        states.append(state)
    for a, b in zip(tree_leaves(states[0]), tree_leaves(states[1])):
        assert torch.equal(a, b)
    tokens = batches[0]["tokens"]
    got, got_kv = M.prefill(params, cfg, tokens, constrain=constrain)
    want, want_kv = M.prefill(params, cfg, tokens)
    assert torch.equal(got, want)
    for a, b in zip(tree_leaves(got_kv), tree_leaves(want_kv)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b",
                                  "h2o-danube-1.8b", "moonshot-v1-16b-a3b"])
def test_world_one_decode_under_constrain_is_the_plain_decode(
        nccl_world_one, arch):
    """Greedy decode through ``decode_step(constrain=)`` with the parameter
    specs and ``cache_pspecs``' caches (``kv_seq=("model",)``) on the
    (1, 1) mesh equals the plain decode bit for bit, its caches the
    whole caches."""
    mesh = nccl_world_one
    cfg = CFG.get_smoke_config(arch)
    rules = rules_for_mesh(mesh, kv_seq=("model",))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    slots, max_seq = 4, 32
    constrain = make_constrain(
        mesh, rules, slots, param_specs=param_pspecs(params, mesh, rules),
        cache_specs=M.cache_specs(cfg, mesh, rules, slots, max_seq))
    first = torch.tensor([[3], [7], [11], [13]], dtype=torch.int32,
                         device="cuda")
    runs = []
    for c in (constrain, None):
        caches = M.init_cache(cfg, slots, max_seq, device="cuda",
                              constrain=c)
        tok, logits = first, []
        for p in range(12):
            out, caches = M.decode_step(
                params, cfg, tok, caches,
                torch.full((slots,), p, dtype=torch.int32, device="cuda"),
                constrain=c)
            tok = out.argmax(-1).to(torch.int32)
            logits.append(out)
        runs.append((torch.stack(logits), caches))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])):
        assert torch.equal(a, b)
