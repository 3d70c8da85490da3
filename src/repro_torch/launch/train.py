"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --smoke --steps 300 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \
        --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen3-0.6b --batch 8 --seq 2048

Port of ``repro.launch.train``: on every rank it builds the local mesh,
(world, 1) over ("data", "model"), with ``rules_for_mesh(mesh,
fsdp=False)`` and ``make_constrain``, so each rank trains on its rows of
every global batch (data parallelism; one rank when run plainly).
``train(..., rules=)`` takes other rules (FSDP, and tensor and expert
parallelism on a mesh whose model axis is larger than 1): the state is
then built leaf by leaf as this rank's blocks under ``param_pspecs``
and the step runs them at run time.  Then
the synthetic data pipeline, the train step, and with ``--ckpt-dir`` the
supervisor with its checkpoint manager and optional failure injection
(``--fail-at``) to show a supervised restart.  Rank 0 prints JAX's
``[train]`` lines and the launches of the attention and scan
kernels, forward and backward, and writes the checkpoints.  ``--smoke``
selects the reduced config; without it the full assigned config is
used.  Runs on the CUDA device ``LOCAL_RANK`` with NCCL unless
``--device cpu`` (gloo) is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

__all__ = ["TrainReport", "train", "kernel_launches", "main"]


@dataclasses.dataclass
class TrainReport:
    losses: list                  # one per step, in order
    seconds: float
    step_seconds: list            # wall of each step (plain loop only)
    grad_norms: list              # each step's grad_norm (plain loop only)
    steps_run: int
    restarts: int
    launches: dict                # this rank's kernel launches in the run
    state: object                 # the final TrainState


def kernel_launches() -> dict:
    """The four LM kernels' launch counters, by name."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_bwd)
    return {f.__name__: f.launches for f in (
        flash_attention, flash_attention_bwd, selective_scan,
        selective_scan_bwd)}


def train(cfg, *, steps: int = 100, batch: int = 8, seq: int = 128,
          lr: float = 3e-3, microbatches: int = 1, remat: str = "nothing",
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          fail_at=(), log_every: int = 10, device=None,
          params: Optional[dict] = None,
          batch_fn: Optional[Callable[[int], dict]] = None,
          log: Callable[[str], None] = print, mesh=None,
          rules=None, pod_compression: bool = False) -> TrainReport:
    """Train ``cfg`` for ``steps`` steps with the JAX driver's optimizer
    settings (``lr`` peak, warmup max(steps // 20, 2), cosine to
    ``steps``).  ``params`` (default: ``init_params`` seeded 0; global
    leaves) and ``batch_fn(step) -> global batch`` (default: the
    synthetic batches) let a caller feed in its own.  ``mesh`` (a live
    ``launch.mesh`` mesh) makes this rank's part of a run across ranks:
    its rows of each batch (split over the batch axes only, replicated
    over "model"), the global loss; only rank 0 logs.  ``rules``
    (default ``rules_for_mesh(mesh, fsdp=False)``, as JAX's launcher) says
    how the parameters are cut: each rank draws every leaf from the
    seeded generator and keeps its block (``sharding.rules.LeafCutter``),
    so every mesh starts from the same global parameters, and the state
    (parameters, moments) is blocks under ``param_pspecs``.
    ``pod_compression``: int8 error feedback on the gradients, its error
    buffers blocks under the same specs (and saved so)."""
    import torch

    from repro_torch.data.synthetic import config_for, make_batch, \
        shard_batch
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import rules_for_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import (P, LeafCutter, make_constrain,
                                            param_pspecs, shard_leaf,
                                            spec_axes)
    from repro_torch.train import (AdamWConfig, TrainConfig,
                                   init_train_state, make_train_step)
    from repro_torch.train.optimizer import OptState
    from repro_torch.train.step import TrainState
    from repro_torch.tree import tree_map

    dev = resolve_device(device)
    tcfg = TrainConfig(
        opt=AdamWConfig(peak_lr=lr, warmup_steps=max(steps // 20, 2),
                        total_steps=steps),
        microbatches=microbatches, remat=remat,
        pod_compression=pod_compression)
    if batch_fn is None:
        scfg = config_for(cfg, batch, seq)
        batch_fn = lambda s: make_batch(scfg, s, device=dev)  # noqa: E731
    constrain, world, state_specs = None, 1, None
    gen = (torch.Generator(device=dev).manual_seed(0) if params is None
           else None)
    if mesh is not None:
        if rules is None:
            rules = rules_for_mesh(mesh, fsdp=False)
        world = mesh.size
        if params is None:
            cutter = LeafCutter(mesh, rules)
            params = M.init_params(cfg, gen, device=dev, shard=cutter)
            specs = cutter.specs
        else:
            specs = param_pspecs(params, mesh, rules)
            params = tree_map(lambda p, s: shard_leaf(p, s, mesh)
                              if spec_axes(s, mesh) else p, params, specs)
        constrain = make_constrain(mesh, rules, batch // microbatches,
                                   param_specs=specs)
        state_specs = TrainState(params=specs, opt=OptState(
            step=P(), m=specs, v=specs),
            ef_error=specs if pod_compression else None)
        global_fn = batch_fn
        batch_fn = lambda s: shard_batch(  # noqa: E731
            global_fn(s), mesh, rules, microbatches)
        if mesh.rank != 0:
            log = lambda line: None  # noqa: E731
    log(f"[train] arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
        f"devices={world} ({dev}) steps={steps}")
    state = init_train_state(cfg, tcfg, gen, device=dev, params=params)
    # the state holds them now; the first step replaces them
    del params
    step_fn = make_train_step(cfg, tcfg, constrain=constrain)
    before = kernel_launches()

    if ckpt_dir:
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.ft import FailureInjector, Supervisor
        sup = Supervisor(ckpt=CheckpointManager(
                             ckpt_dir, keep=3, specs=state_specs,
                             mesh=mesh if state_specs else None),
                         step_fn=step_fn, batch_fn=batch_fn,
                         checkpoint_every=ckpt_every)
        injector = FailureInjector(tuple(fail_at)) if fail_at else None
        t0 = time.time()
        state, rep = sup.run(state, total_steps=steps, injector=injector)
        dt = time.time() - t0
        log(f"[train] done: steps={rep.steps_run} restarts={rep.restarts} "
            f"loss {rep.losses[0]:.4f} -> {rep.losses[-1]:.4f} "
            f"({dt:.1f}s, {rep.steps_run/dt:.2f} steps/s)")
        losses, steps_run, restarts = rep.losses, rep.steps_run, rep.restarts
        step_seconds, grad_norms = [], []
    else:
        t0 = time.time()
        losses, step_seconds, grad_norms = [], [], []
        for s in range(steps):
            ts = time.perf_counter()
            state, m = step_fn(state, batch_fn(s))
            loss = float(m["loss"])         # waits for the step's work
            step_seconds.append(time.perf_counter() - ts)
            losses.append(loss)
            grad_norms.append(float(m["grad_norm"]))
            if s % log_every == 0:
                log(f"[train] step {s:5d} loss {loss:.4f} "
                    f"lr {float(m['lr']):.2e} "
                    f"gnorm {grad_norms[-1]:.3f}")
        dt = time.time() - t0
        log(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"({dt:.1f}s, {steps/dt:.2f} steps/s)")
        steps_run, restarts = steps, 0
    after = kernel_launches()
    launches = {k: after[k] - before[k] for k in after}
    log(f"[train] kernel launches: flash_attention fwd "
        f"{launches['flash_attention']} bwd "
        f"{launches['flash_attention_bwd']}, selective_scan fwd "
        f"{launches['selective_scan']} bwd "
        f"{launches['selective_scan_bwd']}")
    return TrainReport(losses=losses, seconds=dt, step_seconds=step_seconds,
                       grad_norms=grad_norms, steps_run=steps_run,
                       restarts=restarts,
                       launches=launches, state=state)


def main(argv=None) -> TrainReport:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="nothing")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="'cpu' (gloo) or the CUDA device LOCAL_RANK "
                         "(NCCL, the default)")
    args = ap.parse_args(argv)

    from repro_torch import configs as CFG
    from repro_torch.launch.mesh import (init_ranks, make_local_mesh,
                                         shutdown_ranks)
    cfg = CFG.get_smoke_config(args.arch) if args.smoke \
        else CFG.get_config(args.arch)
    dev = init_ranks(args.device)
    try:
        return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                     lr=args.lr, microbatches=args.microbatches,
                     remat=args.remat, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, fail_at=args.fail_at,
                     log_every=args.log_every, device=dev.type,
                     mesh=make_local_mesh())
    finally:
        shutdown_ranks()


if __name__ == "__main__":
    main()
