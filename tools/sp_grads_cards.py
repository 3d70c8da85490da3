#!/usr/bin/env python
"""The first step's gradients of qwen3-0.6b at full size in bf16 across
cards, leaf by leaf: with ``rules_for_mesh(mesh, sp=True)`` and with
tensor parallelism alone on (1, N), each against one card's (rank 0), on
one global batch of 4 x 2048 synthetic tokens.

For each leaf it prints the largest absolute difference from one card's
gradient (of the leaf's largest |gradient|) and the share of elements
whose sign differs from one card's: AdamW's first update is close to
the gradient's sign times the learning rate, so a flipped sign moves an
element by twice the learning rate.  The sp drift that ``chip_smoke.py
--sharded``'s ``[sp-cards-bf16]`` reports is looked for here.

``update``: the first step's update (the parameters after one AdamW
step of ``launch.train.train`` less the drawn ones), leaf by leaf, with
sp and with TP alone, each against one card's: the largest difference
in units of the step's learning rate, and the share of elements whose
update differs from one card's by more than the learning rate (an
update whose sign flipped moves by about twice it).

``seeds``: ``chip_smoke.py``'s ``[sp-cards-bf16]`` runs (one card, sp,
TP alone; the synthetic batches of each data seed) over SEEDS data
seeds and SEED_STEPS steps, each run's relative loss difference from
one card's at every step.

Run on N >= 2 cards (any of ``grads``, ``update``, ``seeds``; default
``grads``)::

    python3 -m torch.distributed.run --nproc-per-node 4 \
        tools/sp_grads_cards.py update seeds
"""
import sys
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ARCH, BATCH, SEQ = "qwen3-0.6b", 4, 2048
SEEDS, SEED_STEPS = tuple(range(8)), 5


def flat(tree, pre=()):
    """{"a/b": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, pre + (k,)))
        else:
            out["/".join(pre + (k,))] = v
    return out


def whole(leaf, spec, mesh):
    """A block under ``spec`` gathered whole on every rank."""
    for dim, entry in enumerate(spec):
        if entry is not None and mesh.axis_size(entry) > 1:
            leaf = mesh.all_gather(leaf, entry, dim)
    return leaf


def grads(cfg, batch, device, mesh=None, rules=None):
    """One card's (``mesh`` None) or this rank's gathered whole gradients
    of the loss at the parameters drawn from a generator seeded 0."""
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import LeafCutter, make_constrain
    from repro_torch.train.step import _sum_over_ranks, loss_and_grads
    from repro_torch.tree import tree_map
    gen = torch.Generator(device=device).manual_seed(0)
    if mesh is None:
        params = M.init_params(cfg, gen, device=device)
        return flat(loss_and_grads(params, cfg, batch)[2])
    cutter = LeafCutter(mesh, rules)
    params = M.init_params(cfg, gen, device=device, shard=cutter)
    constrain = make_constrain(mesh, rules, BATCH, param_specs=cutter.specs)
    g = _sum_over_ranks(loss_and_grads(params, cfg, batch,
                                       constrain=constrain)[2], constrain)
    with torch.no_grad():
        return flat(tree_map(lambda t, s: whole(t, s, mesh), g,
                             cutter.specs))


def grads_report(device, rank, world):
    from repro_torch import configs as CFG
    from repro_torch.data.synthetic import config_for, make_batch
    from repro_torch.launch.mesh import make_mesh, rules_for_mesh
    cfg = CFG.get_config(ARCH)
    batch = make_batch(config_for(cfg, BATCH, SEQ), 0, device=device)
    mesh = make_mesh((1, world), ("data", "model"))
    got = {name: grads(cfg, batch, device, mesh, rules_for_mesh(mesh, sp=sp))
           for name, sp in (("sp", True), ("tp", False))}
    if rank == 0:
        one = grads(cfg, batch, device)
        flips = {name: [0, 0] for name in got}
        print(f"{ARCH} bf16 on (1, {world}), 4 x {SEQ}, step 1; per leaf: "
              f"numel, max |g| one card, then for sp and tp: max |diff| / "
              f"max |g|, sign flips (share of elements)")
        for key, g1 in one.items():
            top = float(g1.float().abs().max())
            cols = []
            for name, g in got.items():
                d = float((g[key].float() - g1.float()).abs().max())
                flip = int((torch.sign(g[key]) != torch.sign(g1)).sum())
                flips[name][0] += flip
                flips[name][1] += g1.numel()
                cols.append(f"{name} {d / top:.3e} {flip / g1.numel():.3e}")
            print(f"{key:28s} {g1.numel():11d} {top:.3e}  " + "  ".join(cols))
        print("all leaves: " + "  ".join(
            f"{name} sign flips {n} of {t} ({n / t:.3e})"
            for name, (n, t) in flips.items()))
    dist.barrier()


def first_update(cfg, device, mesh=None, rules=None):
    """(drawn parameters, parameters after one step of ``train``, the
    step's learning rate), whole on every rank, flat."""
    from repro_torch.launch.train import train
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import LeafCutter
    from repro_torch.train.optimizer import AdamWConfig, warmup_cosine
    from repro_torch.tree import tree_map
    rep = train(cfg, steps=1, batch=BATCH, seq=SEQ, device=device,
                mesh=mesh, rules=rules, log=lambda line: None)
    after = rep.state.params
    if mesh is not None:
        cutter = LeafCutter(mesh, rules)
        gen = torch.Generator(device=device).manual_seed(0)
        M.init_params(cfg, gen, device=device, shard=cutter)
        specs = cutter.specs
        with torch.no_grad():
            after = tree_map(lambda t, s: whole(t, s, mesh), after, specs)
    lr = float(warmup_cosine(AdamWConfig(peak_lr=3e-3, warmup_steps=2,
                                         total_steps=1),
                             torch.tensor(1, dtype=torch.int32)))
    return flat(after), lr


def update_report(device, rank, world):
    """``update`` (see the module's docstring)."""
    from repro_torch import configs as CFG
    from repro_torch.launch.mesh import make_mesh, rules_for_mesh
    from repro_torch.models import model as M
    cfg = CFG.get_config(ARCH)
    mesh = make_mesh((1, world), ("data", "model"))
    got = {name: first_update(cfg, device, mesh,
                              rules_for_mesh(mesh, sp=sp))[0]
           for name, sp in (("sp", True), ("tp", False))}
    if rank == 0:
        one, lr = first_update(cfg, device)
        gen = torch.Generator(device=device).manual_seed(0)
        p0 = flat(M.init_params(cfg, gen, device=device))
        moved = {name: [0, 0] for name in got}
        print(f"{ARCH} bf16 on (1, {world}), 4 x {SEQ}, the first AdamW "
              f"update (lr {lr!r}); per leaf: numel, then for sp and tp: "
              f"max |update - one card's| / lr, share of elements whose "
              f"update differs by more than lr")
        for key, a1 in one.items():
            u1 = a1.float() - p0[key].float()
            cols = []
            for name, after in got.items():
                d = (after[key].float() - p0[key].float() - u1).abs()
                big = int((d > lr).sum())
                moved[name][0] += big
                moved[name][1] += u1.numel()
                cols.append(f"{name} {float(d.max()) / lr:.3e} "
                            f"{big / u1.numel():.3e}")
            print(f"{key:28s} {u1.numel():11d}  " + "  ".join(cols))
        print("all leaves: " + "  ".join(
            f"{name} {n} of {t} ({n / t:.3e}) elements moved by more than "
            f"lr" for name, (n, t) in moved.items()))
    dist.barrier()


def seeds_report(device, rank, world):
    """``seeds`` (see the module's docstring)."""
    import chip_smoke as cs
    from repro_torch.launch.mesh import make_mesh, rules_for_mesh
    mesh = make_mesh((1, world), ("data", "model"))
    worst = {"sp": [], "tp": []}
    for seed in SEEDS:
        one = None
        if rank == 0:
            one = cs.run_train_sharded(device, None, None, ARCH, BATCH,
                                       SEED_STEPS, data_seed=seed)["losses"]
        for name, sp in (("sp", True), ("tp", False)):
            got = cs.run_train_sharded(device, mesh,
                                       rules_for_mesh(mesh, sp=sp), ARCH,
                                       BATCH, SEED_STEPS, data_seed=seed)
            if rank != 0:
                continue
            errs = [abs(a - b) / abs(b) for a, b in zip(got["losses"], one)]
            worst[name].append(max(errs))
            print(f"seed {seed} {name}: losses {got['losses']!r} against "
                  f"one card's {one!r}; relative difference by step "
                  f"{errs!r}")
    if rank == 0:
        for name, errs in worst.items():
            print(f"{name}: largest relative difference per seed {errs!r}; "
                  f"median {sorted(errs)[len(errs) // 2]!r}, above 1e-3 on "
                  f"{sum(e > 1e-3 for e in errs)} of {len(errs)} seeds")
    dist.barrier()


def main():
    from repro_torch.launch.mesh import init_ranks, shutdown_ranks
    modes = sys.argv[1:] or ["grads"]
    device = init_ranks()
    rank, world = dist.get_rank(), dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    for mode in modes:
        {"grads": grads_report, "update": update_report,
         "seeds": seeds_report}[mode](device, rank, world)
    shutdown_ranks()


if __name__ == "__main__":
    main()
