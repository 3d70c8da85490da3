"""The dry-run: one rank's flops, bytes, collective wire bytes and peak
memory for every (architecture x input shape) cell on the production
meshes, under the sharding rules the port runs (``repro.launch.dryrun``
in PyTorch).  Nothing is allocated on a device: it runs on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single

Per cell it writes ``artifacts/dryrun/<arch>__<shape>__<mesh>[__opts].json``
with JAX's keys; ``launch.simulate --lm-profile`` reads it.

How it counts, against JAX's:

- **One rank's program, traced.** JAX lowers and compiles the global
  program with its shardings and reads XLA's per-device analyses.  The
  port has no compiler between it and the card: each rank runs its own
  eager program.  So the dry-run builds rank 0's blocks of the state and
  inputs as shape-only tensors (``FakeTensorMode``), as the ranks build
  theirs: the parameters drawn and cut leaf by leaf (``LeafCutter``),
  the caches allocated as blocks (``init_cache(constrain=)``), the
  rank's rows of ``launch.specs``' global inputs; and it runs rank 0's
  train step, prefill or decode step on
  them through the code the cards run, on an abstract mesh of the
  production shape (``Mesh`` in count mode: its collectives record and
  return tensors of the right shape).  Rank 0 stands for every rank:
  the specs cut every dim into equal blocks (``block_shape`` refuses
  anything else), the sequence split and the batch split are the same
  on every rank, and what differs between ranks (which block, which
  experts, which positions a rank writes) is an index, never a shape
  or a branch; so every rank runs the same operators on the same
  shapes and the same collectives.
- **Flops.** ``torch.utils.flop_counter.FlopCounterMode`` counts the
  matrix products of the operators (forward and backward), and the
  flash-attention and selective-scan kernels' operators by the kernels'
  own formulas (``kernels.work``): on shape-only tensors the wrappers
  take the card's route, where each operator stands in for a launch.
  Elementwise operators count nothing, where XLA's cost analysis counts
  them.
- **No extrapolation.** JAX's cost analysis counts a loop body once, so
  JAX compiles depth-1 and depth-2 programs with unrolled inner scans
  (``models.costmode``) and extrapolates to the full depth.  An eager
  trace runs every layer and every chunk, so the full program's costs
  are counted as they are and ``costmode`` has no counterpart.  The
  depth-1 and depth-2 programs (``num_layers`` one and two times the
  pattern's length) are traced too and written as ``cost_depth1`` and
  ``cost_depth2`` with JAX's keys (``depth_costs``), so a reader can
  extrapolate as JAX does; for an eager trace, linear in depth, that
  gives the full program's count.
- **Bytes, memory, collectives.** See ``launch.cost_analysis``: the
  operand and result bytes of every traced operator (an upper bound
  for an eager program) stand in for XLA's bytes accessed; the peak of
  the storages alive during the trace, inputs included, for XLA's
  memory analysis; the mesh's recorded collectives for the HLO's.
  ``alias_bytes`` are the outputs that are inputs updated in place (a
  decode step's caches): the port donates nothing.

``--ssm-bf16`` sets ``ModelConfig.ssm_scan_bf16`` and is recorded in
``options``, as JAX's; it changes no count, as the port's scan kernel
never writes the [B, Q, di, N] decay and cumprod tensors whose traffic
the flag halves in JAX (``models.ssm``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as CFG
from repro_torch.kernels.work import KERNELS
from repro_torch.launch import specs as SP
from repro_torch.launch.cost_analysis import (Tally, collective_bytes,
                                              roofline_terms)
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     rules_for_mesh)
from repro_torch.models import model as M
from repro_torch.sharding.rules import (LeafCutter, batch_pspec,
                                        cache_pspecs, make_constrain,
                                        shard_leaf, spec_axes)
from repro_torch.tree import tree_leaves

__all__ = ["lower_cell", "measure", "depth_costs", "kernel_flops",
           "run_cell", "main", "Program"]

_DEFAULTS = (("sp", True), ("kv_model", True), ("fsdp", True),
             ("ep_fsdp", True), ("ssm_bf16", False), ("remat", "nothing"),
             ("microbatches", 1))


def _mesh_and_chips(which: str):
    if which == "multi":
        return make_production_mesh(multi_pod=True), 512
    return make_production_mesh(multi_pod=False), 256


def _rules_for(shape_name: str, mesh, sp: bool, kv_model: bool,
               fsdp: bool, ep_fsdp: bool = True):
    if shape_name == "long_500k":
        r = rules_for_mesh(mesh, kv_seq=("data", "model"), fsdp=fsdp)
    elif shape_name == "decode_32k":
        r = rules_for_mesh(mesh, kv_seq=("model",) if kv_model else (),
                           fsdp=fsdp)
    else:
        r = rules_for_mesh(mesh, sp=sp, fsdp=fsdp)
    return dataclasses.replace(r, expert_fsdp=ep_fsdp)


@dataclasses.dataclass
class Program:
    """One rank's program on shape-only tensors: ``run()`` runs it once
    and returns its outputs; ``inputs`` are its arguments (the state,
    parameters, batch or caches), ``mode`` the ``FakeTensorMode`` they
    belong to, ``mesh`` the abstract mesh it runs on."""
    run: Callable[[], object]
    inputs: tuple
    mode: FakeTensorMode
    mesh: Mesh


def _rows(batch: dict, mesh, rules, b: int) -> dict:
    """This rank's rows of a global batch (``batch_pspec`` at ``b``)."""
    out = {}
    for k, x in batch.items():
        spec = batch_pspec(mesh, rules, x.ndim, b)
        out[k] = shard_leaf(x, spec, mesh) if spec_axes(spec, mesh) else x
    return out


def lower_cell(cfg, shape_name: str, mesh, chips: int, *,
               sp: bool = True, kv_model: bool = True, fsdp: bool = True,
               ep_fsdp: bool = True, ssm_bf16: bool = False,
               remat: str = "nothing", microbatches: int = 1):
    """Build rank 0's program of one cell on shape-only tensors; returns
    (``Program``, info with ``lower_s`` and the analytic
    ``model_flops``).  ``shape_name`` names a cell of ``CFG.SHAPES`` or
    is a ``CFG.ShapeSpec`` (its ``name`` picks the rules, as the cell's
    would)."""
    from repro_torch.train import (AdamWConfig, TrainConfig,
                                   init_train_state, make_train_step)

    t0 = time.time()
    shape = shape_name if isinstance(shape_name, CFG.ShapeSpec) \
        else CFG.SHAPES[shape_name]
    if ssm_bf16:
        cfg = dataclasses.replace(cfg, ssm_scan_bf16=True)
    rules = _rules_for(shape.name, mesh, sp, kv_model, fsdp, ep_fsdp)
    b = shape.global_batch
    mode = FakeTensorMode()
    with mode:
        # drawn leaf by leaf and cut, as every rank draws them (train)
        cutter = LeafCutter(mesh, rules)
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu", shard=cutter)
    pspecs = cutter.specs

    if shape.kind == "train":
        tcfg = TrainConfig(opt=AdamWConfig(), remat=remat,
                           microbatches=microbatches)
        batch = SP.train_inputs(cfg, shape, mode)
        with mode:
            state = init_train_state(cfg, tcfg, params=params)
            batch = _rows(batch, mesh, rules, b)
        constrain = make_constrain(mesh, rules, b // microbatches,
                                   param_specs=pspecs)
        step = make_train_step(cfg, tcfg, constrain=constrain)
        inputs = (state, batch)
        run = lambda: step(state, batch)  # noqa: E731
        model_flops = 6 * cfg.active_param_count() * b * shape.seq_len

    elif shape.kind == "prefill":
        batch = SP.prefill_inputs(cfg, shape, mode)
        with mode:
            batch = _rows(batch, mesh, rules, b)
        constrain = make_constrain(mesh, rules, b, param_specs=pspecs)
        inputs = (params, batch)
        run = lambda: M.prefill(  # noqa: E731
            params, cfg, batch["tokens"],
            vision_embeds=batch.get("vision_embeds"), constrain=constrain)
        model_flops = 2 * cfg.active_param_count() * b * shape.seq_len

    else:  # decode
        inp = SP.decode_inputs(cfg, shape, mode)
        cspecs = cache_pspecs(cfg, mesh, rules, b, inp["caches"])
        constrain = make_constrain(mesh, rules, b, param_specs=pspecs,
                                   cache_specs=cspecs)
        with mode:
            # this rank's block of each cache, as init_cache allocates it
            caches = M.init_cache(cfg, b, shape.seq_len, device="cpu",
                                  constrain=constrain)
            rows = _rows({"t": inp["tokens_new"], "p": inp["position"]},
                         mesh, rules, b)
        tokens, position = rows["t"], rows["p"]
        inputs = (params, tokens, caches, position)
        run = lambda: M.decode_step(  # noqa: E731
            params, cfg, tokens, caches, position, constrain=constrain)
        model_flops = 2 * cfg.active_param_count() * b   # one token each

    return Program(run, inputs, mode, mesh), {
        "lower_s": time.time() - t0, "compile_s": None,
        "model_flops": model_flops}


def _storages(tree) -> dict:
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def kernel_flops(counter: FlopCounterMode) -> dict:
    """The flops ``counter`` counted in each kernel's operator."""
    counts = counter.get_flop_counts().get("Global", {})
    return {name: counts[op] for name in KERNELS
            if (op := getattr(torch.ops.repro_torch, name)) in counts}


def measure(program: Program, *, cost: bool = True,
            memory: bool = True) -> dict:
    """Run ``program`` once and count: ``flops`` (products and the
    kernels' own work), ``bytes``, ``by_kernel`` flops, the recorded
    ``collectives`` (with ``cost``), and the ``memory`` analysis (with
    ``memory``); ``trace_s``, the wall time of the run."""
    out: dict = {}
    with contextlib.ExitStack() as stack:
        stack.enter_context(program.mode)
        tally = stack.enter_context(Tally(program.inputs if memory
                                          else ()))
        log = stack.enter_context(program.mesh.recording())
        flops = stack.enter_context(FlopCounterMode(display=False)) \
            if cost else None
        t0 = time.time()
        result = program.run()
        out["trace_s"] = time.time() - t0
    if cost:
        stats = collective_bytes(log)
        out.update(flops=flops.get_total_flops(), bytes=tally.accessed,
                   by_kernel=kernel_flops(flops),
                   collectives={"wire_bytes": stats.wire_bytes,
                                "by_kind": stats.by_kind,
                                "counts": stats.counts},
                   entries=log)
    if memory:
        ins, outs = _storages(program.inputs), _storages(result)
        mem = {"argument_bytes": sum(ins.values()),
               "output_bytes": sum(outs.values()),
               "alias_bytes": sum(n for k, n in outs.items() if k in ins)}
        mem["temp_bytes"] = max(0, tally.peak - mem["argument_bytes"]
                                - mem["output_bytes"] + mem["alias_bytes"])
        mem["peak_bytes_per_device"] = tally.peak
        out["memory"] = mem
    return out


def _costs(got: dict) -> dict:
    """A ``measure``'s costs under JAX's ``_costs`` keys."""
    c = got["collectives"]
    return {"flops": got["flops"], "bytes": got["bytes"],
            "wire": c["wire_bytes"], "by_kind": c["by_kind"],
            "counts": c["counts"]}


def depth_costs(cfg, shape_name, mesh, chips: int, **opts
                ) -> tuple[dict, dict]:
    """The costs of the cell's programs at ``num_layers`` one and two
    times the pattern's length (JAX's depth-1 and depth-2 programs), in
    JAX's keys: ``a + (num_blocks - 1) * (b - a)`` of them is the full
    program's."""
    plen = len(cfg.pattern)
    return tuple(
        _costs(measure(lower_cell(dataclasses.replace(cfg, num_layers=n),
                                  shape_name, mesh, chips, **opts)[0],
                       memory=False))
        for n in (plen, 2 * plen))


def _tag(arch: str, shape_name: str, mesh_kind: str, opts: dict) -> str:
    tag = f"{arch}__{shape_name}__{mesh_kind}"
    nondefault = {k: v for k, v in opts.items() if (k, v) not in _DEFAULTS}
    if nondefault:
        tag += "__" + "__".join(f"{k}-{v}"
                                for k, v in sorted(nondefault.items()))
    return tag


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             with_cost: bool = True, cost_only: bool = False,
             **opts) -> dict:
    """Trace one cell and write its JSON; ``with_cost`` False: memory
    only (JAX's multi-pod pass); ``cost_only``: keep the memory analysis
    of the cell's existing JSON and count the costs anew."""
    cfg = CFG.get_config(arch)
    if not CFG.shape_applicable(cfg, shape_name):
        raise SystemExit(
            f"{arch} x {shape_name}: documented skip (quadratic attention)")
    mesh, chips = _mesh_and_chips(mesh_kind)
    tag = _tag(arch, shape_name, mesh_kind, opts)
    path = os.path.join(out_dir, tag + ".json")
    reuse = cost_only and os.path.exists(path)
    program, info = lower_cell(cfg, shape_name, mesh, chips, **opts)
    got = measure(program, cost=with_cost, memory=not reuse)
    if reuse:
        with open(path) as f:
            got["memory"] = json.load(f)["memory"]
    mem = got["memory"]
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "chips": chips, "params": cfg.param_count(),
              "active_params": cfg.active_param_count(),
              "options": opts, **info, "trace_s": got["trace_s"],
              "memory": mem}
    if with_cost:
        depth = depth_costs(cfg, shape_name, mesh, chips, **opts)
        roof = roofline_terms(
            hlo_flops=got["flops"], hlo_bytes=got["bytes"],
            collective_wire_bytes=got["collectives"]["wire_bytes"],
            chips=chips, model_flops=info["model_flops"])
        result.update(
            cost_per_device={"flops": got["flops"],
                             "bytes_accessed": got["bytes"]},
            cost_depth1=depth[0], cost_depth2=depth[1],
            kernel_flops=got["by_kernel"],
            collectives=got["collectives"], roofline=roof)
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=float)
    line = (f"[dryrun] {tag}: peak/dev="
            f"{mem['peak_bytes_per_device'] / 1e9:.2f}GB")
    if with_cost:
        r = result["roofline"]
        line += (f" compute={r['compute_s'] * 1e3:.2f}ms "
                 f"memory={r['memory_s'] * 1e3:.2f}ms "
                 f"collective={r['collective_s'] * 1e3:.2f}ms "
                 f"dominant={r['dominant']} "
                 f"frac={r['roofline_fraction']:.3f}")
    print(line + f" (trace {got['trace_s']:.1f}s)", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--kv-model", type=int, default=1)
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--ep-fsdp", type=int, default=1)
    ap.add_argument("--ssm-bf16", type=int, default=0)
    ap.add_argument("--remat", default="nothing")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-cost", action="store_true",
                    help="memory only (the multi-pod pass)")
    ap.add_argument("--cost-only", action="store_true",
                    help="count the costs anew, keep the memory analysis "
                         "of the existing artifact")
    args = ap.parse_args(argv)

    opts = dict(sp=bool(args.sp), kv_model=bool(args.kv_model),
                fsdp=bool(args.fsdp), ep_fsdp=bool(args.ep_fsdp),
                ssm_bf16=bool(args.ssm_bf16), remat=args.remat,
                microbatches=args.microbatches)
    if not args.all:
        run_cell(args.arch, args.shape, args.mesh, args.out,
                 with_cost=not args.no_cost, cost_only=args.cost_only,
                 **opts)
        return
    t0 = time.time()
    ok, failed, skipped = 0, [], 0
    for arch, shape_name, applicable in CFG.all_cells():
        if not applicable:
            skipped += 1
            print(f"[dryrun] SKIP {arch} x {shape_name} "
                  f"(quadratic attention at 500k)", flush=True)
            continue
        try:
            tag = _tag(arch, shape_name, args.mesh, opts)
            if args.skip_existing and os.path.exists(
                    os.path.join(args.out, tag + ".json")):
                ok += 1
                print(f"[dryrun] exists, skip {tag}", flush=True)
                continue
            run_cell(arch, shape_name, args.mesh, args.out,
                     with_cost=not args.no_cost,
                     cost_only=args.cost_only, **opts)
            ok += 1
        except Exception as e:     # noqa: BLE001 (one cell's failure)
            failed.append((arch, shape_name, repr(e)))
            traceback.print_exc()
    print(f"[dryrun] mesh={args.mesh} ok={ok} skipped={skipped} "
          f"failed={len(failed)} ({time.time() - t0:.1f}s)")
    for f in failed:
        print("[dryrun] FAILED:", f)
    raise SystemExit(1 if failed else 0)


if __name__ == "__main__":
    main()
