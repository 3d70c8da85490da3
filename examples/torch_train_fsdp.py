"""Training with sharded parameters across ranks: FSDP over "data" and
tensor (and expert) parallelism over "model", one rank a card.

    PYTHONPATH=src torchrun --nproc-per-node 2 examples/torch_train_fsdp.py \
        --arch falcon-mamba-7b --steps 3 --batch 2 --seq 2048
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_train_fsdp.py \
        --arch qwen3-0.6b --model 2 --steps 3 --batch 4 --seq 2048
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_train_fsdp.py \
        --arch qwen3-0.6b --smoke --model 2 --device cpu

The mesh is ("data", "model") = (world / --model, --model) with JAX's
default rules (``rules_for_mesh``: FSDP over "data"); every rank draws
each parameter from the same seed and keeps its block, so falcon-mamba-7b
at all 64 layers (~87 GB of parameters, gradients and AdamW moments) is
never whole on one card.  Rank 0 prints the ``[train]`` lines and this
rank's parameter and moment bytes.
"""
import argparse

from repro_torch import configs as CFG
from repro_torch.launch.mesh import (init_ranks, make_mesh, rules_for_mesh,
                                     shutdown_ranks)
from repro_torch.launch.train import train
from repro_torch.tree import tree_leaves

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="falcon-mamba-7b")
ap.add_argument("--smoke", action="store_true")
ap.add_argument("--model", type=int, default=1,
                help="size of the model axis (tensor parallelism)")
ap.add_argument("--steps", type=int, default=3)
ap.add_argument("--batch", type=int, default=2)
ap.add_argument("--seq", type=int, default=2048)
ap.add_argument("--device", default=None,
                help="'cpu' (gloo) or the CUDA device LOCAL_RANK (NCCL, "
                     "the default)")
args = ap.parse_args()

cfg = CFG.get_smoke_config(args.arch) if args.smoke \
    else CFG.get_config(args.arch)
dev = init_ranks(args.device)
try:
    import torch.distributed as dist
    world = dist.get_world_size()
    if world % args.model:
        raise SystemExit(f"--model {args.model} does not divide the world "
                         f"of {world}")
    mesh = make_mesh((world // args.model, args.model), ("data", "model"))
    rep = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                log_every=1, device=dev.type, mesh=mesh,
                rules=rules_for_mesh(mesh))
    held = sum(t.numel() * t.element_size() for tree in (
        rep.state.params, rep.state.opt.m, rep.state.opt.v)
        for t in tree_leaves(tree))
    if mesh.rank == 0:
        print(f"[train-fsdp] mesh {mesh.shape}: rank 0 holds {held} bytes "
              f"of parameters and moments")
finally:
    shutdown_ranks()
