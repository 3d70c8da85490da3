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

Run on N >= 2 cards::

    python3 -m torch.distributed.run --nproc-per-node 4 tools/sp_grads_cards.py
"""
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ARCH, BATCH, SEQ = "qwen3-0.6b", 4, 2048


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


def main():
    from repro_torch import configs as CFG
    from repro_torch.data.synthetic import config_for, make_batch
    from repro_torch.launch.mesh import (init_ranks, make_mesh,
                                         rules_for_mesh, shutdown_ranks)
    device = init_ranks()
    rank, world = dist.get_rank(), dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
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
    shutdown_ranks()


if __name__ == "__main__":
    main()
