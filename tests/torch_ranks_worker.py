"""Rank bodies for the port's multi-rank CPU tests (gloo), started by
``torch.multiprocessing.spawn`` from ``test_torch_dp.py`` and
``test_torch_moe_ep.py``.  Imports no JAX: each rank reads its inputs from
a file the test wrote and writes its results to ``out{world}_{rank}.pt``
beside it; the test compares them with the single process and with JAX.
"""
import dataclasses
import os

import torch


def _start(rank, world, tmp):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_ranks
    init_ranks("cpu", rank=rank, world_size=world,
               init_method=f"file://{os.path.join(tmp, f'store{world}')}")


def _tcfg(kw):
    from repro_torch.train import AdamWConfig, TrainConfig
    return TrainConfig(opt=AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                       total_steps=10), **kw)


def _cfg(arch, kw):
    from repro_torch import configs as CFG
    return dataclasses.replace(CFG.get_smoke_config(arch), **kw)


def dp(rank, world, tmp):
    """Data parallelism on a (world, 1) mesh: the train step on every
    case, the MoE block's global routing, allreduce_compressed; at world
    2 a supervised restart and a checkpoint, at world 4 its elastic
    restore."""
    from repro_torch.checkpoint import CheckpointManager, restore
    from repro_torch.data.synthetic import shard_batch
    from repro_torch.launch.mesh import (make_local_mesh, rules_for_mesh,
                                         shutdown_ranks)
    from repro_torch.launch.train import train
    from repro_torch.models.moe import moe_block
    from repro_torch.sharding.rules import P, make_constrain, param_pspecs
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.compression import allreduce_compressed
    from repro_torch.train.optimizer import OptState

    _start(rank, world, tmp)
    spec = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    mesh = make_local_mesh()
    rules = rules_for_mesh(mesh, fsdp=False)
    out = {"cases": {}, "moe": {}}
    for name, case in spec["cases"].items():
        cfg, tcfg = _cfg(case["arch"], case["cfg"]), _tcfg(case["tcfg"])
        state = init_train_state(cfg, tcfg, params=case["params"])
        rows = case["batches"][0]["tokens"].shape[0] // tcfg.microbatches
        step = make_train_step(cfg, tcfg,
                               constrain=make_constrain(mesh, rules, rows))
        losses = []
        for batch in case["batches"]:
            state, m = step(state, shard_batch(batch, mesh, rules,
                                               tcfg.microbatches))
            losses.append(m["loss"])
        out["cases"][name] = {"losses": losses, "params": state.params}
        if name == spec["ckpt_case"]:
            last = state

    x = spec["moe"]["x"]
    constrain = make_constrain(mesh, rules, x.shape[0])
    mine = shard_batch({"x": x}, mesh, rules)["x"]
    for factor in spec["moe"]["factors"]:
        cfg = _cfg(spec["moe"]["arch"], {"capacity_factor": factor})
        y, aux = moe_block(spec["moe"]["params"], cfg, mine,
                           constrain=constrain)
        out["moe"][factor] = {"y": y, **aux}

    tree = spec["allreduce"]
    out["allreduce"] = allreduce_compressed(
        mesh, "data", {k: v[rank] for k, v in tree.items()})

    sup_dir = os.path.join(tmp, "sup")
    ckpt_dir = os.path.join(tmp, "ckpt")
    if world == 2:
        cfg = _cfg("qwen3-0.6b", {})
        quiet = lambda line: None  # noqa: E731
        plain = train(cfg, steps=8, batch=8, seq=16, device="cpu",
                      mesh=mesh, log=quiet)
        sup = train(cfg, steps=8, batch=8, seq=16, device="cpu", mesh=mesh,
                    ckpt_dir=sup_dir, ckpt_every=3, fail_at=(5,), log=quiet)
        out["supervisor"] = {"plain": plain.losses, "sup": sup.losses,
                             "restarts": sup.restarts,
                             "plain_params": plain.state.params,
                             "sup_params": sup.state.params}
        CheckpointManager(ckpt_dir).save(3, last, blocking=True)
    else:
        # elastic: world 2's checkpoint onto (world, 1) with FSDP specs
        fsdp = rules_for_mesh(mesh, fsdp=True)
        ps = param_pspecs(last.params, mesh, fsdp)
        specs = dataclasses.replace(last, params=ps, opt=OptState(
            step=P(), m=ps, v=ps))
        got = restore(ckpt_dir, 3, last, mesh=mesh, specs=specs)
        out["elastic"] = {"got": got, "specs": specs}
    shutdown_ranks()
    torch.save(out, os.path.join(tmp, f"out{world}_{rank}.pt"))


def ep(rank, world, tmp):
    """Expert parallelism on a (2, world // 2) mesh: ``moe_block`` (the EP
    path) per variant, and per gradient variant this rank's gradients of
    the global loss sum(y * r) + 0.01 * load_balance_loss, summed over
    the data axis where the leaf is this rank's share."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh, shutdown_ranks
    from repro_torch.models.config import ModelConfig, uniform_pattern
    from repro_torch.models.moe import moe_block
    from repro_torch.sharding.rules import (ShardingRules, make_constrain,
                                            param_pspecs, shard_leaf)
    from repro_torch.tree import tree_map

    _start(rank, world, tmp)
    spec = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    mesh = make_mesh((2, world // 2), ("data", "model"))
    x, r = spec["x"], spec["r"]
    rows = x.shape[0] // 2
    d = mesh.axis_index("data")
    mine, r_mine = (t[d * rows:(d + 1) * rows] for t in (x, r))
    out = {"fwd": {}, "grad": {}}
    for key, v in spec["variants"].items():
        cfg = ModelConfig(pattern=uniform_pattern(moe=True),
                          **dict(spec["cfg"], capacity_factor=v["factor"]))
        rules = ShardingRules(batch=("data",), fsdp=("data",),
                              expert_fsdp=v["expert_fsdp"])
        constrain = make_constrain(mesh, rules, x.shape[0])
        specs = param_pspecs(spec["params"], mesh, rules)
        params = tree_map(lambda p, s: shard_leaf(p, s, mesh),
                          spec["params"], specs)
        if not v["grad"]:
            with torch.no_grad():
                y, aux = moe_block(params, cfg, mine, constrain=constrain)
            out["fwd"][key] = {"y": y, **aux}
            continue
        live = {k: p.requires_grad_(True) for k, p in params.items()}
        xg = mine.clone().requires_grad_(True)
        y, aux = moe_block(live, cfg, xg, constrain=constrain)
        loss = mesh.psum((y * r_mine).sum(), "data") \
            + 0.01 * aux["load_balance_loss"]
        loss.backward()
        grads = {}
        for k, p in live.items():
            g = p.grad
            gathered = v["expert_fsdp"] and k != "router" and \
                "data" in tuple(specs[k])
            if not gathered:
                dist.all_reduce(g, group=mesh.group("data"))
            grads[k] = g
        out["grad"][key] = {"params": grads, "x": xg.grad,
                            "specs": specs}
    shutdown_ranks()
    torch.save(out, os.path.join(tmp, f"out{world}_{rank}.pt"))


def cards(rank, world, tmp):
    """On ``world`` cards with NCCL: qwen3-0.6b's smoke config trained 3
    steps on a (world, 1) mesh, and moonshot's smoke MoE block on a
    (1, world) mesh (the EP path) at capacity factor 64."""
    from repro_torch import configs as CFG
    from repro_torch.launch.mesh import (init_ranks, make_local_mesh,
                                         make_mesh, shutdown_ranks)
    from repro_torch.launch.train import train
    from repro_torch.models.moe import moe_block
    from repro_torch.sharding.rules import (ShardingRules, make_constrain,
                                            param_pspecs, shard_leaf)
    from repro_torch.tree import tree_map

    dev = init_ranks(rank=rank, world_size=world,
                     init_method=f"file://{os.path.join(tmp, 'store')}")
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    rep = train(CFG.get_smoke_config("qwen3-0.6b"), steps=3, batch=8,
                seq=64, device="cuda", mesh=make_local_mesh(),
                log=lambda line: None)
    mesh = make_mesh((1, world), ("data", "model"))
    cfg = _cfg("moonshot-v1-16b-a3b", {"capacity_factor": 64.0})
    rules = ShardingRules()
    moe = {k: v.to(dev) for k, v in spec["moe"].items()}
    moe = tree_map(lambda p, s: shard_leaf(p, s, mesh), moe,
                   param_pspecs(moe, mesh, rules))
    with torch.no_grad():
        y, aux = moe_block(moe, cfg, spec["x"].to(dev),
                           constrain=make_constrain(mesh, rules,
                                                    spec["x"].shape[0]))
    out = {"losses": rep.losses,
           "params": tree_map(lambda t: t.cpu(), rep.state.params),
           "y": y.cpu(), "aux": {k: v.cpu() for k, v in aux.items()}}
    shutdown_ranks()
    torch.save(out, os.path.join(tmp, f"out{world}_{rank}.pt"))


def _whole(leaf, spec, mesh):
    """A block under ``spec`` gathered whole (every rank gets it)."""
    for dim, entry in enumerate(spec):
        if entry is not None and mesh.axis_size(entry) > 1:
            leaf = mesh.all_gather(leaf, entry, dim)
    return leaf


def sharded(rank, world, tmp):
    """FSDP and tensor/expert parallelism at run time on the meshes of
    ``inputs.pt`` (all in one world): per mesh and case, 3 train steps on
    this rank's blocks under ``param_pspecs`` (losses, grad norms, the
    parameters gathered whole, every block's shape); the prefill's
    logits on the prefill mesh; a sharded checkpoint of the checkpoint
    mesh's state (and one of its parameters alone), restored on the
    restore mesh."""
    from repro_torch.checkpoint import restore, save
    from repro_torch.data.synthetic import shard_batch
    from repro_torch.launch.mesh import (make_mesh, rules_for_mesh,
                                         shutdown_ranks)
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import (P, make_constrain, param_pspecs,
                                            shard_leaf)
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.optimizer import OptState
    from repro_torch.train.step import TrainState
    from repro_torch.tree import tree_flatten, tree_leaves, tree_map

    _start(rank, world, tmp)
    spec = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    meshes = {name: make_mesh(shape, ("data", "model"))
              for name, shape in spec["meshes"].items()}
    out = {"train": {}, "prefill": None, "restored": None}
    states = {}
    for mname, mesh in meshes.items():
        rules = dataclasses.replace(rules_for_mesh(mesh),
                                    **spec["rules"].get(mname, {}))
        for name, case in spec["cases"].items():
            cfg, tcfg = _cfg(case["arch"], case["cfg"]), _tcfg({})
            specs = param_pspecs(case["params"], mesh, rules)
            mine = tree_map(lambda p, s: shard_leaf(p, s, mesh),
                            case["params"], specs)
            rows = case["batches"][0]["tokens"].shape[0]
            constrain = make_constrain(mesh, rules, rows, param_specs=specs)
            state = init_train_state(cfg, tcfg, params=mine)
            step = make_train_step(cfg, tcfg, constrain=constrain)
            losses, norms = [], []
            for batch in case["batches"]:
                state, m = step(state, shard_batch(batch, mesh, rules))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            with torch.no_grad():
                whole = tree_map(lambda p, s: _whole(p, s, mesh),
                                 state.params, specs)
            shapes = {k: [tuple(t.shape) for t in tree_leaves(tree)]
                      for k, tree in (("params", state.params),
                                      ("m", state.opt.m),
                                      ("v", state.opt.v))}
            out["train"][mname, name] = {
                "losses": losses, "grad_norms": norms, "shapes": shapes,
                "specs": tree_leaves(specs),
                "params": whole if rank == 0 else None}
            if (mname, name) == spec["prefill"]:
                tokens = case["batches"][0]["tokens"]
                logits, _ = M.prefill(mine, cfg, tokens, constrain=constrain)
                out["prefill"] = logits
            states[mname, name] = (state, specs)
    # a checkpoint of one mesh's state, restored on another
    (src, case), dst = spec["ckpt"], spec["restore_on"]
    ckpt = os.path.join(tmp, "ckpt")

    def state_specs(specs):
        return TrainState(params=specs, opt=OptState(step=P(), m=specs,
                                                     v=specs))
    state, specs = states[src, case]
    save(ckpt, 3, state, mesh=meshes[src], specs=state_specs(specs))
    # the parameters alone: the layout of JAX's tree of parameters
    save(os.path.join(tmp, "ckpt_params"), 3, state.params, mesh=meshes[src],
         specs=specs)
    with torch.no_grad():
        out["saved"] = tree_map(lambda p, s: _whole(p, s, meshes[src]),
                                state, state_specs(specs))
    like, specs = states[dst, case]
    out["restored"] = restore(ckpt, 3, like, mesh=meshes[dst],
                              specs=state_specs(specs))
    out["restored_specs"] = tree_flatten(state_specs(specs))[1]
    shutdown_ranks()
    torch.save(out, os.path.join(tmp, f"out{world}_{rank}.pt"))


def _rows(batch, mesh, rules):
    from repro_torch.data.synthetic import shard_batch
    return shard_batch(batch, mesh, rules)


def sp_decode(rank, world, tmp):
    """The sequence-parallel residual stream and decode under tensor
    parallelism on the meshes of ``inputs.pt`` (all in one world): per
    prefill case the logits through ``prefill`` with ``sp`` rules; per
    train case 3 steps with ``sp`` rules (losses, grad norms, the
    parameters gathered whole); per decode case one ``decode_step`` on
    this rank's blocks of the parameters and of the global caches under
    ``cache_pspecs`` (the logits, the updated blocks, the blocks'
    shapes as ``init_cache(constrain=)`` allocated them); per serve
    case the greedy tokens of ``make_serve_step`` over its steps."""
    from repro_torch.launch.mesh import (make_mesh, rules_for_mesh,
                                         shutdown_ranks)
    from repro_torch.models import model as M
    from repro_torch.serve.engine import (ServeConfig, init_server,
                                          make_serve_step, submit)
    from repro_torch.sharding.rules import (make_constrain, param_pspecs,
                                            shard_leaf)
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    _start(rank, world, tmp)
    spec = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    meshes = {name: make_mesh(shape, ("data", "model"))
              for name, shape in spec["meshes"].items()}
    out = {"prefill": {}, "train": {}, "decode": {}, "serve": {}}

    def mine(mesh, rules, params):
        specs = param_pspecs(params, mesh, rules)
        return tree_map(lambda p, s: shard_leaf(p, s, mesh), params,
                        specs), specs

    for key, case in spec["prefill"].items():
        mesh = meshes[case["mesh"]]
        rules = rules_for_mesh(mesh, sp=True)
        cfg = _cfg(case["arch"], case["cfg"])
        params, specs = mine(mesh, rules, case["params"])
        tokens = case["tokens"]
        constrain = make_constrain(mesh, rules, tokens.shape[0],
                                   param_specs=specs)
        logits, _ = M.prefill(params, cfg,
                              _rows({"t": tokens}, mesh, rules)["t"],
                              constrain=constrain)
        out["prefill"][key] = {"logits": logits,
                               "seq_axis": constrain.seq_axis(
                                   tokens.shape[1])}

    for key, case in spec["train"].items():
        mesh = meshes[case["mesh"]]
        rules = rules_for_mesh(mesh, sp=True)
        cfg, tcfg = _cfg(case["arch"], case["cfg"]), _tcfg({})
        params, specs = mine(mesh, rules, case["params"])
        rows = case["batches"][0]["tokens"].shape[0]
        constrain = make_constrain(mesh, rules, rows, param_specs=specs)
        state = init_train_state(cfg, tcfg, params=params)
        step = make_train_step(cfg, tcfg, constrain=constrain)
        losses, norms = [], []
        for batch in case["batches"]:
            state, m = step(state, _rows(batch, mesh, rules))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        with torch.no_grad():
            whole = tree_map(lambda p, s: _whole(p, s, mesh), state.params,
                             specs)
        out["train"][key] = {"losses": losses, "grad_norms": norms,
                             "params": whole if rank == 0 else None}

    for key, case in spec["decode"].items():
        mesh = meshes[case["mesh"]]
        rules = rules_for_mesh(mesh, kv_seq=case["kv_seq"])
        cfg = _cfg(case["arch"], case["cfg"])
        params, specs = mine(mesh, rules, case["params"])
        b, smax = case["tokens"].shape[0], case["max_seq"]
        cspecs = M.cache_specs(cfg, mesh, rules, b, smax)
        constrain = make_constrain(mesh, rules, b, param_specs=specs,
                                   cache_specs=cspecs)
        caches = M.init_cache(cfg, b, smax, device="cpu",
                              constrain=constrain)
        shapes = [tuple(c.shape) for c in tree_leaves(caches)]
        tree_map(lambda c, g, s: c.copy_(shard_leaf(g, s, mesh)), caches,
                 case["caches"], cspecs)
        rows = _rows({"t": case["tokens"], "p": case["position"]}, mesh,
                     rules)
        logits, caches = M.decode_step(params, cfg, rows["t"], caches,
                                       rows["p"], constrain=constrain)
        out["decode"][key] = {"logits": logits, "caches": caches,
                              "shapes": shapes,
                              "specs": tree_leaves(cspecs)}

    for key, case in spec["serve"].items():
        mesh = meshes[case["mesh"]]
        rules = rules_for_mesh(mesh, kv_seq=case["kv_seq"])
        cfg = _cfg(case["arch"], case["cfg"])
        params, specs = mine(mesh, rules, case["params"])
        scfg = ServeConfig(**case["scfg"])
        constrain = make_constrain(
            mesh, rules, scfg.slots, param_specs=specs,
            cache_specs=M.cache_specs(cfg, mesh, rules, scfg.slots,
                                      scfg.max_seq))
        state = init_server(cfg, scfg, device="cpu", constrain=constrain)
        for slot, prompt in enumerate(case["prompts"]):
            state = submit(state, slot, prompt, case["max_new"])
        step = make_serve_step(cfg, scfg, params, constrain=constrain)
        toks = []
        for _ in range(case["steps"]):
            state, tok = step(state)
            toks.append(tok)
        out["serve"][key] = torch.stack(toks)
    shutdown_ranks()
    torch.save(out, os.path.join(tmp, f"out{world}_{rank}.pt"))


def live_cell(cfg, shape, mesh):
    """A closure that runs this rank's program of a dry-run cell (``shape``
    a ``configs.ShapeSpec``) on a live ``mesh`` with real tensors: the
    parameters drawn seeded and cut, the cell's rules
    (``dryrun._rules_for``), the rank's rows of a synthetic batch or of
    zeroed caches."""
    from repro_torch.data.synthetic import config_for, make_batch, \
        shard_batch
    from repro_torch.launch.dryrun import _rules_for
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import LeafCutter, make_constrain
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train import AdamWConfig, TrainConfig

    rules = _rules_for(shape.name, mesh, True, True, True, True)
    cutter = LeafCutter(mesh, rules)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", shard=cutter)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        cspecs = M.cache_specs(cfg, mesh, rules, b, s)
        constrain = make_constrain(mesh, rules, b, param_specs=cutter.specs,
                                   cache_specs=cspecs)
        caches = M.init_cache(cfg, b, s, device="cpu", constrain=constrain)
        tok = (b, 1, cfg.num_codebooks) if cfg.num_codebooks else (b, 1)
        rows = shard_batch({"t": torch.randint(2, cfg.vocab_size, tok),
                            "p": torch.arange(b, dtype=torch.int32) % s},
                           mesh, rules)
        return lambda: M.decode_step(params, cfg, rows["t"], caches,
                                     rows["p"], constrain=constrain)
    rows = shard_batch(make_batch(config_for(cfg, b, s - (
        cfg.vision_tokens or 0)), 0, device="cpu"), mesh, rules)
    constrain = make_constrain(mesh, rules, b, param_specs=cutter.specs)
    if shape.kind == "prefill":
        return lambda: M.prefill(params, cfg, rows["tokens"],
                                 vision_embeds=rows.get("vision_embeds"),
                                 constrain=constrain)
    tcfg = TrainConfig(opt=AdamWConfig())
    state = init_train_state(cfg, tcfg, params=params)
    step = make_train_step(cfg, tcfg, constrain=constrain)
    return lambda: step(state, rows)


def dryrun_ranks(rank, world, tmp):
    """The collectives each dry-run cell of ``inputs.pt`` runs on a live
    mesh: the entries ``Mesh.recording()`` collects, by case."""
    from repro_torch import configs as CFG
    from repro_torch.launch.mesh import make_mesh, shutdown_ranks

    _start(rank, world, tmp)
    spec = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    meshes = {shape: make_mesh(shape, ("data", "model"))
              for shape in spec["meshes"]}
    out = {}
    for key, (arch, mesh_shape, shape) in spec["cases"].items():
        mesh = meshes[mesh_shape]
        run = live_cell(CFG.get_smoke_config(arch), CFG.ShapeSpec(*shape),
                        mesh)
        with mesh.recording() as log:
            run()
        out[key] = log
    shutdown_ranks()
    torch.save(out, os.path.join(tmp, f"out{world}_{rank}.pt"))


def sweep_ranks(rank, world, tmp):
    """``run_sharded``/``run_grid`` over a live 1-D mesh of ``world``
    ranks, every case of ``inputs.pt`` in every spelling, and (world 4)
    ``federated_run`` on a ("dc",) mesh: every rank's whole results."""
    from repro_torch.core import federation, sweep
    from repro_torch.launch.mesh import make_mesh, shutdown_ranks

    _start(rank, world, tmp)
    spec = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    mesh = make_mesh((world,), ("sweep",))
    out = {}
    for name, case in spec["cases"].items():
        for part, inner in case["spellings"]:
            kw = dict(mesh=mesh, max_steps=case["max_steps"],
                      partitioner=part)
            if case["grid"]:
                out[name, part, inner] = sweep.run_grid(
                    case["batch"], *sweep.policy_grid(), **kw)
            else:
                out[name, part, inner] = sweep.run_sharded(
                    case["batch"], inner=inner, **kw)
    if world == len(spec["federation"]["stack"].time):
        dc = make_mesh((world,), ("dc",))
        out["federation"] = federation.federated_run(
            spec["federation"]["stack"], mesh=dc,
            max_steps=spec["federation"]["max_steps"])
    shutdown_ranks()
    torch.save(out, os.path.join(tmp, f"out{world}_{rank}.pt"))


def ef_sharded(rank, world, tmp):
    """Int8 error feedback on sharded leaves, on the meshes of
    ``inputs.pt`` for this world: per mesh and gradient case, this rank's
    blocks of the global gradients and error buffers through
    ``ef_compress_tree(..., mesh=, specs=)``, the wire and new error
    gathered whole.  On the train mesh (world 4): 3 steps of the train
    step with ``pod_compression`` on this rank's blocks (losses, the
    state gathered whole), and the same run cut after 2 steps by a
    sharded save and restore (its third step's state gathered whole)."""
    from repro_torch.checkpoint import restore, save
    from repro_torch.launch.mesh import (make_mesh, rules_for_mesh,
                                         shutdown_ranks)
    from repro_torch.sharding.rules import (P, make_constrain, param_pspecs,
                                            shard_leaf)
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.compression import ef_compress_tree
    from repro_torch.train.optimizer import OptState
    from repro_torch.train.step import TrainState
    from repro_torch.tree import tree_map

    _start(rank, world, tmp)
    spec = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    out = {"ef": {}, "train": None}
    for mname, shape in spec["meshes"][world].items():
        mesh = make_mesh(shape, ("data", "model"))
        specs = param_pspecs(spec["grads"]["f32"], mesh,
                             rules_for_mesh(mesh))
        for case, grads in spec["grads"].items():
            cut = lambda tree: tree_map(  # noqa: E731
                lambda x, s: shard_leaf(x, s, mesh), tree, specs)
            wire, err = ef_compress_tree(cut(grads), cut(spec["error"]),
                                         mesh=mesh, specs=specs)
            out["ef"][mname, case] = tree_map(
                lambda x, s: _whole(x, s, mesh), (wire, err), (specs, specs))
    if world == 4:
        case = spec["train"]
        mesh = make_mesh(case["mesh"], ("data", "model"))
        rules = rules_for_mesh(mesh)
        cfg, tcfg = _cfg(case["arch"], {}), _tcfg({"pod_compression": True})
        specs = param_pspecs(case["params"], mesh, rules)
        mine = tree_map(lambda p, s: shard_leaf(p, s, mesh), case["params"],
                        specs)
        rows = case["batches"][0]["tokens"].shape[0]
        step = make_train_step(cfg, tcfg, constrain=make_constrain(
            mesh, rules, rows, param_specs=specs))
        state_specs = TrainState(params=specs, opt=OptState(
            step=P(), m=specs, v=specs), ef_error=specs)
        state = init_train_state(cfg, tcfg, params=mine)
        losses = []
        for i, batch in enumerate(case["batches"]):
            if i == 2:
                ckpt = os.path.join(tmp, "ckpt")
                save(ckpt, 2, state, mesh=mesh, specs=state_specs)
                back = restore(ckpt, 2, state, mesh=mesh, specs=state_specs)
                resumed, _ = step(back, _rows(batch, mesh, rules))
            state, m = step(state, _rows(batch, mesh, rules))
            losses.append(float(m["loss"]))
        whole = lambda st: tree_map(  # noqa: E731
            lambda x, s: _whole(x, s, mesh), st, state_specs)
        with torch.no_grad():
            out["train"] = {"losses": losses, "state": whole(state),
                            "resumed": whole(resumed)}
    shutdown_ranks()
    torch.save(out, os.path.join(tmp, f"out{world}_{rank}.pt"))


def moe_split(rank, world, tmp):
    """MoE across ranks where the port used to refuse, per case of
    ``inputs.pt`` for this world (forward, and with ``r`` the gradients
    of sum(y * r) + 0.01 * load_balance_loss, gathered whole):
    - world 3, ("data", "model") = (1, 3): ``moe_block`` on experts that
      do not divide the model axis, the leaves this rank's blocks under
      ``param_pspecs``; the gradients where every rank holds every row;
    - world 4: ``moe_block`` on (2, 2) with one row (the tokens split
      over "data", the rows not), and ``moe_block_ep`` on ("pod",
      "data", "model") = (2, 2, 1) with two rows (the rows split over
      "pod", the tokens over both); then a loss and its gradients with
      ``fsdp=("pod", "data")`` while the rows split over "pod" alone."""
    from repro_torch.launch.mesh import make_mesh, shutdown_ranks
    from repro_torch.models.moe import moe_block, moe_block_ep
    from repro_torch.sharding.rules import (ShardingRules, make_constrain,
                                            param_pspecs, shard_leaf)
    from repro_torch.train.step import _sum_over_ranks, loss_and_grads
    from repro_torch.tree import tree_map

    _start(rank, world, tmp)
    spec = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    meshes = {}
    out = {}
    for key, case in spec["cases"].items():
        if case["world"] != world:
            continue
        names, shape = case["mesh"]
        if (names, shape) not in meshes:
            meshes[names, shape] = make_mesh(shape, names)
        mesh = meshes[names, shape]
        rules = ShardingRules(**case["rules"])
        if case["kind"] == "loss":
            cfg = _cfg(case["arch"], {})
            specs = param_pspecs(case["params"], mesh, rules)
            mine = tree_map(lambda p, s: shard_leaf(p, s, mesh),
                            case["params"], specs)
            rows = case["batch"]["tokens"].shape[0]
            constrain = make_constrain(mesh, rules, rows, param_specs=specs)
            loss, _, grads = loss_and_grads(
                mine, cfg, _rows(case["batch"], mesh, rules),
                constrain=constrain)
            grads = _sum_over_ranks(grads, constrain)
            with torch.no_grad():
                out[key] = {"loss": loss, "rows": constrain.batch_axes,
                            "grads": tree_map(lambda g, s: _whole(
                                g, s, mesh), grads, specs)}
            continue
        cfg = _cfg(case["arch"], case["cfg"])
        specs = param_pspecs(case["params"], mesh, rules)
        live = {k: shard_leaf(p, specs[k], mesh).requires_grad_(True)
                for k, p in case["params"].items()}
        x = case["x"].clone().requires_grad_(True)
        constrain = make_constrain(mesh, rules, x.shape[0],
                                   param_specs=specs)
        mine = _rows({"x": x}, mesh, rules)["x"]
        with torch.set_grad_enabled(case["r"] is not None):
            if case["ep"]:
                y, aux = moe_block_ep(live, cfg, mine, constrain)
            else:
                y, aux = moe_block(live, cfg, mine, constrain=constrain)
        res = {"y": y.detach(), "rows": constrain.batch_axes,
               **{k: v.detach() for k, v in aux.items()}}
        if case["r"] is not None:
            # every rank holds all the rows: its gradients are whole
            assert not constrain.batch_axes
            ((y * case["r"]).sum()
             + 0.01 * aux["load_balance_loss"]).backward()
            with torch.no_grad():
                res["grads"] = {k: _whole(p.grad, specs[k], mesh)
                                for k, p in live.items()}
                res["x_grad"] = x.grad
        out[key] = res
    shutdown_ranks()
    torch.save(out, os.path.join(tmp, f"out{world}_{rank}.pt"))
