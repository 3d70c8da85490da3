#!/usr/bin/env python
"""How far moonshot-v1-16b-a3b's bf16 prefill across cards parts from one
card's when no pair drops: the prefill of one 2048-token request at
capacity factor E/k (11: a capacity of at least the tokens) on
("data", "model") = (1, N), expert parallelism with the tokens whole,
and on (2, N/2), where the tokens split over "data" while the one row
does not (``chip_smoke.py --sharded``'s ``[moe-ep-tokens-cards]``), each
against one card's prefill of the whole model (rank 0, first).  It
prints the last position's logits error of max |logit| on each mesh:
when the two meshes part alike, the drift belongs to the cards' bf16
sums, not to the token split.

Run on N >= 4 cards::

    python3 -m torch.distributed.run --nproc-per-node 4 \\
        tools/moe_ep_drift_cards.py
"""
import dataclasses
import gc
import sys
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ARCH, SEQ = "moonshot-v1-16b-a3b", 2048


def main():
    import chip_smoke as cs
    from repro_torch import configs as CFG
    from repro_torch.launch.mesh import (init_ranks, make_mesh,
                                         rules_for_mesh, shutdown_ranks)
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import LeafCutter, make_constrain

    device = init_ranks()
    rank, world = dist.get_rank(), dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    base = CFG.get_config(ARCH)
    cfg = dataclasses.replace(base, capacity_factor=float(
        -(-base.num_experts // base.num_experts_per_tok)))
    tokens = torch.randint(2, cfg.vocab_size, (1, SEQ),
                           generator=torch.Generator(
                               device=device).manual_seed(1), device=device)

    def prefill(params, constrain=None):
        with torch.no_grad():
            return M.prefill(params, cfg, tokens,
                             constrain=constrain)[0].float().cpu()

    def drawn(mesh=None):
        gen = torch.Generator(device=device).manual_seed(0)
        if mesh is None:
            return M.init_params(cfg, gen, device=device), None
        rules = rules_for_mesh(mesh)
        cutter = LeafCutter(mesh, rules)
        params = M.init_params(cfg, gen, device=device, shard=cutter)
        return params, make_constrain(mesh, rules, 1,
                                      param_specs=cutter.specs)

    ref = None
    if rank == 0:
        params, _ = drawn()
        ref = prefill(params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    for shape in ((1, world), (2, world // 2)):
        params, constrain = drawn(make_mesh(shape, ("data", "model")))
        got = prefill(params, constrain)
        del params, constrain
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            err = float((got - ref).abs().max() / ref.abs().max())
            top = bool(torch.equal(got.argmax(-1), ref.argmax(-1)))
            print(f"[moe-ep-drift] {ARCH} bf16, 1 x {SEQ}, capacity factor "
                  f"{cfg.capacity_factor!r} (no pair drops), mesh {shape}, "
                  f"rank 0: logits error {err!r} of max |logit| against one "
                  f"card's, top-1 equal {top} ({card})", flush=True)
    dist.barrier()
    shutdown_ranks()


if __name__ == "__main__":
    main()
